"""Windowed adagrad, and RMSProp/Adam with R-hat-gated iterate averaging.

PyTorch port of viabel_tpu/optimizers.py (42-165, 201-230, 245-349 for
adagrad; 352-487 and 721-962 for the iterate-averaging optimizers).
The JAX package compiles a whole adagrad run into one `lax.scan`.  Here
its state lives on the device and each iteration is the objective's value
and gradient followed by one hand-written step kernel
(`ops.adagrad.adagrad_step`) that reads the iteration from a counter on
the device; on the card a presampled objective's run is that body captured
in a CUDA graph and replayed, so no iteration waits for the host.  A batch
of K runs (`_adagrad_runs`, the batched pipelines' optimizer) is the same
body with a leading run axis: ``torch.func.vmap`` of the objective's
gradient and one launch of the step kernel for every run.  The IA
optimizers' chain step runs eagerly: a Python loop over iterations, the
learning rate a host float, nothing waiting for the device.  Their chains
are a batch dimension: one batched step an iteration through
``torch.func.vmap`` of the objective's gradient, as the JAX package vmaps
its scan.  The scan-unroll knob (`resolve_unroll`) tuned a
TPU compiler and has no counterpart here.

An objective that samples inside its step (built with
``presampled=False``) draws iteration i from a generator seeded with
``ops.philox.fold_in(seed, i)``, the counterpart of the JAX package's
``fold_in(key, i)``: the run's seed is drawn once from the caller's
generator (each chain's from the chain's), so iteration i's draws depend
on nothing before it, and a segmented or resumed run draws what the whole
run drew.  Progress lines (``progress=True``) and the segmented chain runs
with checkpoints (``checkpoint_path=``, `checkpoint.py`) follow the JAX
package's.  Given a mesh (``mesh=``), the chains split over its ``chain``
axis, each device group running its chains as one batch on its device
(`parallel.sharded_chains`), and every rank gathers the results.
"""
import os

import numpy as np
import torch

from ._device import (capture, default_generator, on_device, pick_driver,
                      resolve_device)
from ._trace import span, to_host
from .diagnostics import (compute_R_hat_adaptive, compute_R_hat_halfway,
                          stochastic_iterate_averaging)
from .objectives import map_draws, stack_draws
from .ops.adagrad import adagrad_step
from .ops.adagrad import new_state as new_adagrad_state
from .ops.adagrad import replay as adagrad_replay
from .ops.gaussian_lw import philox_normal
from .ops.philox import fold_in, philox_seed

__all__ = ['learning_rate_schedule', 'adagrad_optimize',
           'rmsprop_IA_optimize_with_rhat', 'adam_IA_optimize_with_rhat',
           'rmsprop_IA_optimize', 'adam_IA_optimize']


def learning_rate_schedule(i, n_iters, learning_rate, learning_rate_end=None):
    """Learning rate at iteration `i`: constant for the first quarter,
    harmonic ``a / (b + i)`` decay over the middle half, constant
    `learning_rate_end` for the last quarter
    (viabel_tpu/optimizers.py:42-77)."""
    if learning_rate <= 0:
        raise ValueError('learning rate must be positive')
    if (learning_rate_end is not None
            and not (0 < learning_rate_end < learning_rate)):
        raise ValueError('final learning rate must satisfy '
                         '0 < learning_rate_end < learning_rate')
    if learning_rate_end is None:
        return float(learning_rate)
    b = n_iters * learning_rate_end / (2 * (learning_rate - learning_rate_end))
    a = learning_rate * b
    start_decrease_at = n_iters // 4
    end_decrease_at = 3 * n_iters // 4
    if i < start_decrease_at:
        return float(learning_rate)
    if i < end_decrease_at:
        return a / (b + i - start_decrease_at + 1)
    return float(learning_rate_end)


def _wrap_objective(objective_and_grad, has_log_norm):
    """Normalize to ``(value, grad, log_norm)``; an objective without a
    log-norm output gets None, which the step kernel takes as the JAX
    package's zero log-norm (viabel_tpu/optimizers.py:125-139) without a
    tensor of zeros an iteration."""
    if has_log_norm is None:
        has_log_norm = getattr(objective_and_grad, 'has_log_norm', False)
    if has_log_norm:
        def obj(var_param, rng_or_draws):
            out = objective_and_grad(var_param, rng_or_draws)
            return out[0], out[1], out[2]
    else:
        def obj(var_param, rng_or_draws):
            value, grad = objective_and_grad(var_param, rng_or_draws)[:2]
            return value, grad, None
    obj.presampled = getattr(objective_and_grad, 'presampled', False)
    obj.host_callback = getattr(objective_and_grad, 'host_callback', False)
    return obj


class _IterationGenerator:
    """The draws of a run whose objective samples inside its step:
    iteration i's generator is one generator of `device` reseeded with
    ``fold_in(seed, i)`` (``at(i)``)."""

    def __init__(self, seed, device):
        self.seed = seed
        self.generator = torch.Generator(device=device)

    def at(self, i):
        return self.generator.manual_seed(fold_in(self.seed, i))


def _progress_report(i, n_iters, value):
    """Progress line after iteration `i` (viabel_tpu/optimizers.py:233-239,
    the reference's running loss)."""
    print('\r  iter {:>7d}/{} | loss = {:<12.6g}'.format(
        int(i) + 1, int(n_iters), float(value)),
        end='' if int(i) + 1 < int(n_iters) else '\n', flush=True)


def _progress(n_iters, values):
    """``report(i)``: the progress line after iteration i when i is one of
    the JAX package's report points (every ``max(n_iters // 100, 1)``
    iterations and the last), reading the loss from the device history
    `values`.  It reads and writes nothing else."""
    every = max(n_iters // 100, 1)

    def report(i):
        if i % every == 0 or i == n_iters - 1:
            _progress_report(i, n_iters, values[i])

    return report


# iterations captured in one CUDA graph of the adagrad loop, chosen by
# measurement (tools/graph_depth.py, PERF.md): at 2000 iterations one
# iteration a graph ran fastest, since capturing an iteration costs the
# host what running it eagerly does and a replay costs less than the card
# spends on it; a one-iteration graph takes any remainder
_GRAPH_ITERS = 1


def _draw_row(draws, counter, batched):
    """The presampled draws of the iteration the device counter names: row
    ``counter[0]`` of a ``(n_iters, n_mc, ...)`` block, or of each run's
    ``(K, n_iters, n_mc, ...)`` block (the runs of a batch stand at one
    iteration), each entry of a dict of blocks alike."""
    dim = 1 if batched else 0
    index = counter[:1]
    return map_draws(lambda v: v.index_select(dim, index).squeeze(dim),
                     draws)


def _draws_of(obj, state, source, i):
    """The draws the objective takes at iteration `i`: for a presampled
    objective the row of its block that the device counter names (so the
    same call serves every iteration of a graph), for any other the
    generator that `source` gives iteration `i`."""
    if getattr(obj, 'presampled', False):
        return _draw_row(source, state.counter, state.param.dim() == 2)
    return source.at(i)


def _adagrad_iteration(obj, state, source, i):
    """Adagrad iteration `i` on the device-side `state`
    (`ops.adagrad.AdagradState`, one run or a batch): the objective's
    value and gradient at ``state.param``, cast to its dtype, then the step
    kernel, which reads the iteration from the device counter.  Nothing in
    it waits for the device or decides on the host, so the same body runs
    eagerly and under capture."""
    value, grad, log_norm = obj(state.param, _draws_of(obj, state, source, i))
    dtype = state.param.dtype
    adagrad_step(state, grad.to(dtype), value.to(dtype),
                 None if log_norm is None else log_norm.to(dtype))


def _adagrad_eager(obj, state, source, start, iters, report=None):
    """Iterations ``start .. start + iters - 1`` of the body, one launch
    after another, each followed by ``report(i)`` when given."""
    for i in range(start, start + iters):
        _adagrad_iteration(obj, state, source, i)
        if report is not None:
            report(i)


def _adagrad_graph(obj, state, source, start, iters, window, report=None):
    """Iterations ``start .. start + iters - 1`` of the body of a
    presampled objective on the card: those before `window` eagerly on a
    side stream (real iterations, which also warm up autograd's and the
    allocator's state and fill the model's device data cache; a run that
    starts past the window evaluates the objective once instead and
    discards the result), then the body captured `_GRAPH_ITERS` times in
    one CUDA graph and once in another, and those graphs replayed until the
    iterations are done, ``report(i)`` after each.  A failed capture
    raises."""
    device = state.param.device
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    warm = min(max(window - start, 0), iters)
    with span('eager'), torch.cuda.stream(side):
        _adagrad_eager(obj, state, source, start, warm, report)
        if warm == 0 and iters:
            obj(state.param, _draws_of(obj, state, source, start))
    full, rest = divmod(iters - warm, _GRAPH_ITERS)
    graphs = []
    for count, steps in ((full, _GRAPH_ITERS), (rest, 1)):
        if count:
            graph = capture(lambda: _adagrad_eager(obj, state, source, 0,
                                                   steps), side)
            graphs.append((graph, steps, count))
    main.wait_stream(side)
    i = start + warm
    with span('replay'):
        for graph, steps, count in graphs:
            for _ in range(count):
                adagrad_replay(graph, steps)
                if report is not None:
                    for j in range(i, i + steps):
                        report(j)
                i += steps


def _learning_rates(n_iters, learning_rate, learning_rate_end, dtype):
    """The schedule of every iteration as a tensor of `dtype`: Python
    floats rounded once to `dtype`, the value the eager step multiplied
    by."""
    return torch.tensor([learning_rate_schedule(i, n_iters, learning_rate,
                                                learning_rate_end)
                         for i in range(n_iters)],
                        dtype=torch.float64).to(dtype)


def _check_ran(counter, end):
    """Raise unless the device counter of a run reached `end`."""
    ran = int(to_host(counter[0]))
    if ran != end:
        raise RuntimeError('the adagrad run stopped at iteration {} of {}'
                           .format(ran, end))


def _advance(obj, state, source, start, iters, window, driver=None,
             report=None, pending=None):
    """Run `state` (one run or a batch, at iteration `start`) through
    iterations ``start .. start + iters - 1`` of the body, by the driver
    that `_device.pick_driver` picks (see `_adagrad_run`),
    and check that every iteration ran (`_check_ran`).  `source` is a
    presampled objective's whole-run block of draws, or an
    `_IterationGenerator`.  Given a list `pending`, the check's arguments
    are appended to it instead, so that nothing waits for the device and
    runs on other devices can be started meanwhile (and the span
    ``vt.optimize`` then ends without a synchronize)."""
    device = state.param.device
    driver = pick_driver(driver, device,
                         getattr(obj, 'host_callback', False),
                         getattr(obj, 'presampled', False))
    with span('optimize', device if pending is None else None):
        if driver == 'graph':
            _adagrad_graph(obj, state, source, start, iters, window, report)
        else:
            _adagrad_eager(obj, state, source, start, iters, report)
        if pending is None:
            _check_ran(state.counter, start + iters)
        else:
            pending.append((state.counter, start + iters))


def _source(draws, device):
    """A presampled block passes through; a generator becomes the run's
    `_IterationGenerator`, its seed drawn once from the generator."""
    if isinstance(draws, torch.Generator):
        return _IterationGenerator(philox_seed(draws), device)
    return draws


def _drive(obj, state, draws, n_iters, window, driver, progress=False,
           pending=None):
    """Run `state` (one run or a batch) through its `n_iters` iterations
    (`_advance`, `pending` as there) from `draws` (a presampled block, or a
    generator), with the progress lines when `progress`; returns
    ``(values, log_norms, params, tail_mean)``."""
    report = _progress(n_iters, state.values) if progress else None
    _advance(obj, state, _source(draws, state.param.device), 0, n_iters,
             window, driver, report, pending)
    tail_mean = state.tail_sum / (n_iters - state.tail_start)
    return state.values, state.log_norms, state.params, tail_mean


def _adagrad_run(obj, n_iters, window, learning_rate, epsilon,
                 learning_rate_end, init_param, draws, keep_history=True,
                 driver=None, progress=False):
    """The whole adagrad run (viabel_tpu/optimizers.py:201-230, 241-303).

    `draws` is the ``(n_iters, n_mc, d)`` block of base draws for a
    presampled objective (row ``i`` feeds iteration ``i``; a dict of such
    blocks for a family with dict draws), or a `torch.Generator` for an
    objective that samples itself (iteration i then draws from
    ``fold_in(seed, i)``, the seed drawn once from the generator).  The
    state of the run lives on the device (`ops.adagrad.AdagradState`) and
    one body (`_adagrad_iteration`) runs every iteration.  The driver is
    chosen by `_device.pick_driver`'s rule: a presampled objective on the
    card runs as a replayed CUDA graph (`_adagrad_graph`); an objective
    that samples from a generator, one on a host-side log density
    (``host_callback``, `models.external`), and any run on the CPU (with
    the plain step), run eagerly.  ``driver='eager'`` or ``'graph'`` names
    one instead (to compare the two); asking for the graph where the rule
    forbids it raises.  The tail-quarter running sum is accumulated in both history
    modes, so the averaged parameter is the same whether or not the
    history is kept.  ``progress=True`` prints the JAX package's progress
    lines (`_progress`): the graph then stops for one host read at each
    report point, and no result changes.

    Returns ``(values, log_norms, params, tail_mean)``; ``params`` is the
    ``(n_iters, P)`` iterate history, or None with ``keep_history=False``.
    """
    state = new_adagrad_state(
        init_param, _learning_rates(n_iters, learning_rate,
                                    learning_rate_end, init_param.dtype),
        window, epsilon, keep_history)
    return _drive(obj, state, draws, n_iters, window, driver, progress)


def _adagrad_runs(objective_and_grad, has_log_norm, n_iters, window,
                  lr_tables, epsilon, inits, draws, keep_history=False,
                  driver=None, pending=None):
    """K adagrad runs at once, the counterpart of the JAX package's
    vmapped scan (viabel_tpu/pipeline.py:399-412, 732-745).

    `inits` is ``(K, P)``, `lr_tables` the ``(K, n_iters)`` learning rate
    of each run and iteration (`_learning_rates` of each run's schedule),
    and `draws` the ``(K, n_iters, n_mc, ...)`` presampled draws (a dict
    of such blocks for dict draws) of a presampled objective.  Each
    iteration is `_batched_objective`'s vmapped value and gradient of every
    run followed by one launch of the step kernel for every run, the body
    that `_adagrad_run` drives: a replayed CUDA graph on the card, eagerly
    on the CPU.  An objective that samples from a generator cannot be
    vmapped: `draws` is then a list of K generators and the runs go one
    after another, eagerly, each as `_adagrad_run` would run it.  Returns
    ``(values (K, n_iters), log_norms (K, n_iters), params (K, n_iters,
    P) or None, tail_means (K, P))``.  `pending` is `_advance`'s.
    """
    if not getattr(objective_and_grad, 'presampled', False):
        obj = _wrap_objective(objective_and_grad, has_log_norm)
        outs = [_drive(obj, new_adagrad_state(init, lr, window, epsilon,
                                              keep_history),
                       generator, n_iters, window, driver, pending=pending)
                for init, lr, generator in zip(inits, lr_tables, draws)]
        return tuple(None if parts[0] is None else torch.stack(parts)
                     for parts in zip(*outs))
    step = _batched_objective(objective_and_grad, has_log_norm)
    state = new_adagrad_state(inits, lr_tables, window, epsilon,
                              keep_history)
    return _drive(step, state, draws, n_iters, window, driver,
                  pending=pending)


def _run_draws(objective_and_grad, obj, generator, n_iters, dtype, draws):
    """What a single adagrad run draws from: a presampled objective's
    ``(n_iters, n_mc, ...)`` block (`draws`, or drawn from `generator`),
    or for any other objective the generator itself."""
    if not obj.presampled:
        if draws is not None:
            raise ValueError('draws= feeds a presampled objective only')
        return generator
    if draws is None:
        return objective_and_grad.make_draws(generator, n_iters, dtype)
    return draws


def adagrad_optimize(n_iters, objective_and_grad, init_param, *,
                     generator=None, has_log_norm=None, window=10,
                     learning_rate=.01, epsilon=.1, learning_rate_end=None,
                     progress=False, return_history=True, device=None,
                     draws=None):
    """Windowed adagrad with min-log-norm gradient rescaling and
    tail-quarter iterate averaging (viabel_tpu/optimizers.py:306-349).

    Returns ``(smoothed_opt_param, variational_param_history,
    value_history, log_norm_history)``; the parameter history covers the
    last quarter of the iterations, and is None with
    ``return_history=False``.  Runs on `device` (None: the CUDA card);
    `generator` defaults to seed 0 on that device.  A presampled objective
    draws its ``(n_iters, n_mc, d)`` block from `generator`, or takes it
    as `draws` (e.g. `interop.presampled_draws` of the JAX package's); any
    other draws iteration i from ``fold_in(seed, i)``, its seed drawn once
    from `generator`.  ``progress=True`` prints a progress line every
    ``max(n_iters // 100, 1)`` iterations and at the last.
    """
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = torch.as_tensor(init_param, device=device)
    draws = _run_draws(objective_and_grad, obj, generator, n_iters,
                       init_param.dtype, draws)
    values, log_norms, params, tail_mean = _adagrad_run(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, draws, keep_history=return_history, progress=progress)
    tail = params[3 * n_iters // 4:] if return_history else None
    return tail_mean, tail, values, log_norms


def _perturbed_inits(init_param, n_optimisers, scale, noise):
    """Chain inits: chain 0 unperturbed; chain o >= 1 gets
    ``init + noise[o] * (o + 1) * scale`` (viabel_tpu/optimizers.py:352-361;
    scale 0.5 for RMSProp, 0.2 for Adam).  `noise` is the
    ``(n_optimisers, P)`` standard-normal block, passed in so that tests
    can share it with the JAX package."""
    mult = (torch.arange(n_optimisers, dtype=init_param.dtype,
                         device=init_param.device) + 1) * scale
    mult[0] = 0.0
    return init_param[None, :] + noise * mult[:, None]


def _batched_objective(objective_and_grad, has_log_norm):
    """``step(params (C, P), draws (C, n_mc, ...)) -> (values (C,), grads
    (C, P), log_norms (C,) or None)``: the objective's value and gradient
    for every chain or run in one batched call, the counterpart of the JAX
    package's vmapped scan.  A KLVI-form objective is ``vmap`` of
    ``grad_and_value`` of its pure ``objective``; a CHIVI-form one (it
    carries ``compute_log_weights``) is ``vmap`` of the objective itself,
    whose gradient is a `torch.func.vjp` of the log-weights with the
    stopped cotangent (viabel_tpu/objectives.py:207-216), and its log-norm
    output is kept when `has_log_norm` (default: the objective's own
    flag), else None (the batched adagrad body: the step kernel takes
    None as 0)."""
    if has_log_norm is None:
        has_log_norm = getattr(objective_and_grad, 'has_log_norm', False)
    if getattr(objective_and_grad, 'compute_log_weights', None) is not None:
        batched = torch.func.vmap(objective_and_grad)

        def step(params, draws):
            value, grad, log_norm = batched(params, draws)[:3]
            return value, grad, log_norm if has_log_norm else None
    else:
        objective = getattr(objective_and_grad, 'objective', None)
        if has_log_norm or objective is None:
            raise NotImplementedError(
                'batched runs take the port\'s objectives: a KLVI form '
                'with its pure `objective`, or a CHIVI form with its '
                '`compute_log_weights`')
        value_and_grad = torch.func.vmap(
            torch.func.grad_and_value(objective))

        def step(params, draws):
            grad, value = value_and_grad(params, draws)
            return value, grad, None

    step.presampled = True
    step.host_callback = getattr(objective_and_grad, 'host_callback', False)
    return step


def _batched_step(objective_and_grad, has_log_norm):
    """`_batched_objective` with a log-norm of zeros where the objective
    has none: the IA chains' step, whose history records the log-norms."""
    objective = _batched_objective(objective_and_grad, has_log_norm)

    def step(params, draws):
        value, grad, log_norm = objective(params, draws)
        return value, grad, (torch.zeros_like(value) if log_norm is None
                             else log_norm)

    step.presampled = True
    step.host_callback = objective.host_callback
    return step


def _chain_step(kind, i, n_iters, learning_rate, epsilon, learning_rate_end,
                param, grad, v, m):
    """One RMSProp or Adam update of every chain; returns
    ``(new_param, v, m)`` (viabel_tpu/optimizers.py:364-417).  'rmsprop':
    EMA of squared gradients with alpha = 0.9; 'adam': moments initialized
    at ``0.9 g`` / ``0.9 g^2`` and bias-corrected with power ``i + 2``."""
    alpha, beta1, beta2 = 0.9, 0.9, 0.999
    lr = learning_rate_schedule(i, n_iters, learning_rate, learning_rate_end)
    if kind == 'rmsprop':
        v = grad ** 2 if i == 0 else v * alpha + (1. - alpha) * grad ** 2
        return param - lr * grad / torch.sqrt(epsilon + v), v, m
    v = 0.9 * grad ** 2 if i == 0 else v * beta2 + (1. - beta2) * grad ** 2
    m = 0.9 * grad if i == 0 else m * beta1 + (1. - beta1) * grad
    m_hat = m / (1 - beta1 ** (i + 2))
    v_hat = v / (1 - beta2 ** (i + 2))
    return param - lr * m_hat / torch.sqrt(epsilon + v_hat), v, m


def _chain_xs(obj, chain_generators, i0, length, dtype):
    """The presampled draws of iterations ``[i0, i0 + length)`` for every
    chain, ``(n_chains, length, n_mc, ...)`` (a dict of such blocks for
    dict draws): one block per chain from its generator
    (viabel_tpu/optimizers.py:420-426)."""
    return stack_draws([obj.make_draws_range(g, i0, length, dtype)
                        for g in chain_generators])


def _generator_draws(obj, chain_seeds, device, dtype):
    """``draw(i)``: every chain's base draws of iteration i for an
    objective that samples inside its step, chain c's from
    ``fold_in(chain_seeds[c], i)`` (the JAX package's ``fold_in(chain_key_c,
    i)``), stacked to ``(n_chains, n_mc, ...)`` for the batched step."""
    generators = [_IterationGenerator(s, device) for s in chain_seeds]

    def draw(i):
        return stack_draws([obj.iteration_draws(g.at(i), dtype)
                            for g in generators])

    return draw


def _rows(draws):
    """``draw(i)`` of a ``(n_chains, n_iters, ...)`` block of draws (or a
    dict of blocks): its iteration-i rows; a callable passes through."""
    if callable(draws):
        return draws
    return lambda i: map_draws(lambda v: v[:, i], draws)


def _chains_segment(step, kind, n_iters, learning_rate, epsilon,
                    learning_rate_end, avg_start, cap, i0, length, carry,
                    draws):
    """Iterations ``[i0, i0 + length)`` of every chain, one batched step an
    iteration (viabel_tpu/optimizers.py:364-417, 490-511).

    `carry` is ``(params, v, m, avg)``, each ``(C, P)``, and is not written
    to.  The history entry of iteration i is the *pre-update* parameter;
    with `avg_start` an online running mean of the post-update parameters
    over iterations ``i > avg_start`` is kept.  Returns the new carry and
    ``(values (C, length), log_norms (C, length), hist)``, `hist` the last
    ``min(length, cap)`` history entries in chronological order (a ring
    buffer of that size while the segment runs).
    """
    param, v, m, avg = carry
    C, P = param.shape
    dtype, device = param.dtype, param.device
    draw = _rows(draws)
    kept = min(length, cap)
    hist = torch.empty((C, kept, P), dtype=dtype, device=device)
    values = torch.empty((C, length), dtype=dtype, device=device)
    log_norms = torch.empty((C, length), dtype=dtype, device=device)
    for j in range(length):
        i = i0 + j
        value, grad, log_norm = step(param, draw(i))
        hist[:, j % kept] = param
        values[:, j] = value
        log_norms[:, j] = log_norm
        new_param, v, m = _chain_step(
            kind, i, n_iters, learning_rate, epsilon, learning_rate_end,
            param, grad.to(dtype), v, m)
        if avg_start is not None:
            avg = (avg + (new_param - avg) / max(i - avg_start, 1)
                   if i > avg_start else new_param)
        param = new_param
    if kept < length:
        hist = torch.roll(hist, -(length % kept), dims=1)
    return (param, v, m, avg), (values, log_norms, hist)


def _chains_run(step, kind, n_iters, learning_rate, epsilon,
                learning_rate_end, inits, draws, hist_cap=None,
                avg_start=None, mesh=None, axis='chain'):
    """Every chain's whole run, one segment of `n_iters`
    (viabel_tpu/optimizers.py:429-487, 792-842).

    `step` is `_batched_step`'s function, `inits` the ``(C, P)`` chain
    inits and `draws` the ``(C, n_iters, n_mc, ...)`` block of draws (the
    presampled block, or injected draws), ``draw(i)``, a function of the
    iteration (`_generator_draws`), or `_GroupDraws`.  With `hist_cap`
    below `n_iters` the history keeps the last `hist_cap` entries (a ring
    buffer), in chronological order.  The chains run as one batch on
    `inits`' device, or with `mesh` as its `axis` groups (`_placement`),
    each group's batch on its device.  Returns ``((values, log_norms,
    chains), final_params, avg_params)`` on the host of every rank.
    """
    C, P = inits.shape
    cap = min(hist_cap, n_iters) if hist_cap is not None else n_iters
    groups, devices = _placement(mesh, axis, C, inits.device)
    local = {}
    for g, dev in devices.items():
        lo, hi, _ = groups[g]
        with on_device(dev):
            init = inits[lo:hi].to(dev)
            zeros = torch.zeros_like(init)
            (param, _, _, avg), (values, lns, hist) = _chains_segment(
                step, kind, n_iters, learning_rate, epsilon,
                learning_rate_end, avg_start, cap, 0, n_iters,
                (init, zeros, zeros, zeros), _group_draws(draws, lo, hi, dev))
            local[g] = torch.cat([values, lns, hist.reshape(hi - lo, -1),
                                  param, avg], dim=1)
    values, lns, hist, param, avg = _gather_groups(
        groups, local, (n_iters, n_iters, cap * P, P, P), inits.dtype,
        torch.device('cpu'))
    return (values, lns, hist.reshape(C, cap, P)), param, avg


class _GroupDraws:
    """The draws of a chain group made where it runs: ``make(lo, hi,
    device)`` gives chains ``[lo, hi)``'s draws on `device` (a block, or
    ``draw(i)``)."""

    def __init__(self, make):
        self.make = make


def _group_draws(draws, lo, hi, device):
    """Chains ``[lo, hi)``'s draws on `device`: a `_GroupDraws` makes
    them, ``draw(i)`` passes through (it draws every chain), and a ``(C,
    n_iters, ...)`` block is sliced and moved."""
    if isinstance(draws, _GroupDraws):
        return draws.make(lo, hi, device)
    if callable(draws):
        return draws
    return map_draws(lambda v: v[lo:hi].to(device), draws)


def _check_chain_mesh(mesh, axis, n_chains):
    from .parallel.sharded_chains import chain_groups
    if axis not in mesh.axis_names:
        raise ValueError(
            'the IA chains split over a mesh axis named {!r}; the given '
            'mesh has axes {} (build it with make_mesh(axis_names=('
            "'chain', ...)))".format(axis, mesh.axis_names))
    return chain_groups(mesh, n_chains, axis)


def _placement(mesh, axis, n_chains, device):
    """The chain groups ``[(lo, hi, entry)]`` and ``{group: device}`` of
    those this rank runs: without a mesh one group of every chain on
    `device` (its entry None), else the mesh's `axis` groups
    (`parallel.sharded_chains.chain_groups`)."""
    if mesh is None:
        return [(0, n_chains, None)], {0: device}
    from .parallel.distributed import rank
    groups = _check_chain_mesh(mesh, axis, n_chains)
    return groups, {g: entry.device for g, (_, _, entry) in enumerate(groups)
                    if entry.rank == rank()}


def _gather_groups(groups, local, widths, dtype, device):
    """Each group's ``(chains, sum(widths))`` pack, computed where it ran
    (`local` maps this rank's groups to their packs, on their devices), on
    `device` of every rank, in chain order, cut into one ``(C, width)``
    tensor a width.  The groups of a mesh cross ranks in one
    `distributed.exchange`."""
    if groups[0][2] is None:
        flat = local[0].to(device)
    else:
        from .parallel.distributed import exchange
        lo, hi, _ = groups[0]
        flat = torch.cat(exchange(local, [e.rank for _, _, e in groups],
                                  (hi - lo, sum(widths)), dtype, device))
    return torch.split(flat, list(widths), dim=1)


def _segment_progress(i_done, n_iters, tail_values):
    """Running-average-loss progress line after a segment
    (viabel_tpu/optimizers.py:559-567); `tail_values` holds the trailing
    ~1000 iterations' losses of every chain."""
    avg_loss = float(np.mean(tail_values))
    print('\r  iter {:>7d}/{} | average loss = {:<12,.6g}'.format(
        i_done, n_iters, avg_loss),
        end='' if i_done < n_iters else '\n', flush=True)


def _chains_run_segmented(step, kind, n_iters, learning_rate, epsilon,
                          learning_rate_end, inits, draws, keys, hist_cap,
                          avg_start, save_every, checkpoint_path, progress,
                          mesh=None, axis='chain'):
    """The chains run in `save_every`-iteration segments, with progress
    lines, checkpoint and resume, and partial results on an interrupt
    (viabel_tpu/optimizers.py:570-718).

    Each segment is `_chains_segment` over the same draws as the whole run
    (`draws` as in `_chains_run`: a presampled block is drawn for the
    whole run and a segment reads its rows), so a segmented run equals the
    whole run.  After each segment the host state (the histories, and with
    a checkpoint the carry) is brought up to date, checkpointed to
    `checkpoint_path` (resumed from it when it exists, after
    `checkpoint._validate_resume` of its shapes, `keys` and
    hyperparameters) and a progress line printed when `progress`.  A
    KeyboardInterrupt between segments returns what is done; one before
    the first segment completes is raised again.

    With `mesh` each device group of its `axis` runs its chains' segments
    on its device (the carry placed there from the host state, a resumed
    one too), and every rank gathers each segment's results, so every
    rank holds the same host state and writes the same checkpoint.

    `keys` is the ``(C, nbytes)`` uint8 stack of the chain generators'
    states at the start of the call (``get_state()``), the checkpoint's
    ``keys`` entry.  Returns ``((values, log_norms, chains), final_params,
    avg_params, i_done)`` as numpy arrays, histories truncated to the
    `i_done` completed iterations.
    """
    from .checkpoint import (FORMAT_CHAINS, _load_resume_state,
                             _validate_resume, save_checkpoint)
    n_chains, P = inits.shape
    np_dtype = torch.empty((), dtype=inits.dtype).numpy().dtype
    cap = min(hist_cap, n_iters) if hist_cap is not None else n_iters
    template = dict(
        format=np.asarray(FORMAT_CHAINS),
        i=np.zeros((), np.int64),
        keys=np.asarray(keys),
        params=np.zeros((n_chains, P), np_dtype),
        v=np.zeros((n_chains, P), np_dtype),
        m=np.zeros((n_chains, P), np_dtype),
        avg=np.zeros((n_chains, P), np_dtype),
        values=np.zeros((n_chains, n_iters), np_dtype),
        lns=np.zeros((n_chains, n_iters), np_dtype),
        hist=np.zeros((n_chains, cap, P), np_dtype),
        kind=np.asarray(str(kind)),
        learning_rate=np.asarray(float(learning_rate)),
        epsilon=np.asarray(float(epsilon)),
        learning_rate_end=np.asarray(
            np.nan if learning_rate_end is None else float(
                learning_rate_end)),
        avg_start=np.asarray(-1 if avg_start is None else int(avg_start),
                             np.int64),
    )
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = _load_resume_state(checkpoint_path, template)
        _validate_resume(state, template, checkpoint_path, 'keys',
                         value_entries=('format', 'kind', 'learning_rate',
                                        'epsilon', 'learning_rate_end',
                                        'avg_start'))
        start = int(state['i'])
    else:
        state = template
        state['params'] = inits.cpu().numpy()
        start = 0
    carry_names = ('params', 'v', 'm', 'avg')
    groups, devices = _placement(mesh, axis, n_chains, inits.device)
    # each group's carry on its device (the placement a resume restores)
    # and its draws
    carry = {g: tuple(torch.as_tensor(state[name][lo:hi]).to(devices[g])
                      for name in carry_names)
             for g, (lo, hi, _) in enumerate(groups) if g in devices}
    group_draws = {g: _group_draws(draws, groups[g][0], groups[g][1],
                                   devices[g]) for g in devices}

    def gathered(local, widths):
        return _gather_groups(groups, local, widths, inits.dtype,
                              torch.device('cpu'))

    i = start
    try:
        while i < n_iters:
            length = min(save_every, n_iters - i)
            keep = min(length, cap)
            local, advanced = {}, {}
            for g, dev in devices.items():
                with on_device(dev):
                    advanced[g], (vals, lns, hist_seg) = _chains_segment(
                        step, kind, n_iters, learning_rate, epsilon,
                        learning_rate_end, avg_start, cap, i, length,
                        carry[g], group_draws[g])
                    parts = [vals, lns, hist_seg.reshape(vals.shape[0], -1)]
                    if checkpoint_path is not None:
                        parts.extend(advanced[g])
                    local[g] = torch.cat(parts, dim=1)
            widths = (length, length, keep * P) + (
                (P,) * 4 if checkpoint_path is not None else ())
            got = gathered(local, widths)
            state['values'][:, i:i + length] = got[0].numpy()
            state['lns'][:, i:i + length] = got[1].numpy()
            # the segment's last min(length, cap) entries, ring-written
            # into the capped host history
            slots = np.arange(i + length - keep, i + length) % cap
            state['hist'][:, slots] = got[2].reshape(
                n_chains, keep, P).numpy()
            carry = advanced
            i += length
            state['i'] = np.asarray(i)
            if checkpoint_path is not None:
                for name, t in zip(carry_names, got[3:]):
                    state[name] = t.numpy()
                save_checkpoint(checkpoint_path, state)
            if progress:
                _segment_progress(
                    i, n_iters, state['values'][:, max(i - 1000, 0):i])
    except KeyboardInterrupt:
        if progress:
            print()
        if i == 0:
            # no completed segment: nothing to return, and an empty history
            # would fail the R-hat post-pass
            raise

    i_done = i
    kept = min(i_done, cap)
    order = (i_done - kept + np.arange(kept)) % cap
    final, avg = gathered({g: torch.cat([c[0], c[3]], dim=1)
                           for g, c in carry.items()}, (P, P))
    return ((state['values'][:, :i_done], state['lns'][:, :i_done],
             state['hist'][:, order]), final.numpy(), avg.numpy(), i_done)


def _ia_postprocess(K, chains, values, log_norms, rhat_window,
                    r_mean_threshold, r_sigma_threshold, tail_avg_iters):
    """R-hat-gated iterate averaging over host histories
    (viabel_tpu/optimizers.py:721-789).

    `chains` is the ``(n_chains, hist_len, P)`` numpy history with the
    location block in ``[:, :, :K]`` and the scale block in ``[:, :, K:]``.
    Averaging of each block starts at the first R-hat window that, with the
    next one, has every dimension below its threshold, or else
    `tail_avg_iters` before the end.  Returns ``(averaged means list,
    averaged sigmas list, values, log_norms, optimisation_log, chains)``.
    """
    hist_len = chains.shape[1]
    rhats = compute_R_hat_adaptive(chains, window_size=rhat_window)
    rhats_halfway = compute_R_hat_halfway(chains, interval=100, start=200)

    rhat_mean_windows, rhat_sigma_windows = rhats[:, :K], rhats[:, K:]

    def find_start(windows, threshold):
        for ee in range(windows.shape[0] - 1):
            if (windows[ee] < threshold).all() and \
               (windows[ee + 1] < threshold).all():
                return ee * rhat_window
        return max(hist_len - tail_avg_iters, 0)

    start_m = find_start(rhat_mean_windows, r_mean_threshold)
    start_s = find_start(rhat_sigma_windows, r_sigma_threshold)
    avg_means, avg_sigmas = [], []
    for o in range(chains.shape[0]):
        avg_means.append(stochastic_iterate_averaging(chains[o, :, :K],
                                                      start_m)[0])
        avg_sigmas.append(stochastic_iterate_averaging(chains[o, :, K:],
                                                       start_s)[0])
    optimisation_log = dict(
        start_avg_mean_iters=start_m,
        start_avg_sigma_iters=start_s,
        r_hat_mean=rhat_mean_windows,
        r_hat_sigma=rhat_sigma_windows,
        r_hat_mean_halfway=rhats_halfway[:, :K],
        r_hat_sigma_halfway=rhats_halfway[:, K:],
    )
    return (avg_means, avg_sigmas, values.reshape(-1), log_norms.reshape(-1),
            optimisation_log, chains)


def _ia_optimize(kind, perturb_scale, n_iters, objective_and_grad,
                 init_param, K, generator, has_log_norm, window,
                 learning_rate, epsilon, rhat_window, averaging,
                 n_optimisers, r_mean_threshold, r_sigma_threshold,
                 tail_avg_iters, learning_rate_end, mesh, checkpoint_path,
                 save_every, progress, device):
    """The body shared by the RMSProp-IA and Adam-IA optimizers
    (viabel_tpu/optimizers.py:792-842): segmented (`_chains_run_segmented`)
    when `checkpoint_path` or `progress` is set, else one segment."""
    presampled = getattr(objective_and_grad, 'presampled', False)
    step = _batched_step(objective_and_grad, has_log_norm)
    if mesh is not None:
        device = mesh.home()
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    init_param = torch.as_tensor(init_param, device=device)
    dtype = init_param.dtype
    # one seed for the init noise and one per chain, from the generator
    init_seed, *chain_seeds = [philox_seed(generator)
                               for _ in range(n_optimisers + 1)]
    noise = philox_normal(n_optimisers, init_param.shape[0], init_seed,
                          dtype=dtype, device=device)
    inits = _perturbed_inits(init_param, n_optimisers, perturb_scale, noise)
    chain_generators = [torch.Generator(device=device).manual_seed(s)
                        for s in chain_seeds]
    if mesh is not None:
        _check_chain_mesh(mesh, 'chain', n_optimisers)

        def make(lo, hi, dev):  # a group's draws, made on its device
            if presampled:
                return _chain_xs(objective_and_grad, [
                    torch.Generator(device=dev).manual_seed(s)
                    for s in chain_seeds[lo:hi]], 0, n_iters, dtype)
            return _generator_draws(objective_and_grad, chain_seeds[lo:hi],
                                    dev, dtype)

        draws = _GroupDraws(make)
    elif presampled:
        draws = _chain_xs(objective_and_grad, chain_generators, 0, n_iters,
                          dtype)
    else:
        draws = _generator_draws(objective_and_grad, chain_seeds, device,
                                 dtype)
    # history cap: at most 100 * window iterates a chain; online tail
    # average from n_iters // 1.3 (viabel_tpu/optimizers.py:812-817)
    hist_cap = 100 * window if window is not None else None
    avg_start = int(n_iters // 1.3) if averaging else None
    if checkpoint_path is not None or progress:
        keys = np.stack([g.get_state().numpy() for g in chain_generators])
        (values, log_norms, chains), final_params, avg_params, _ = \
            _chains_run_segmented(
                step, kind, n_iters, learning_rate, epsilon,
                learning_rate_end, inits, draws, keys, hist_cap, avg_start,
                save_every, checkpoint_path, progress, mesh)
    else:
        (values, log_norms, chains), final_params, avg_params = _chains_run(
            step, kind, n_iters, learning_rate, epsilon, learning_rate_end,
            inits, draws, hist_cap, avg_start, mesh)
        values, log_norms, chains, final_params, avg_params = (
            t.numpy() for t in (values, log_norms, chains, final_params,
                                avg_params))
    (avg_means, avg_sigmas, value_history, log_norm_history,
     optimisation_log, host_chains) = _ia_postprocess(
        K, chains, values, log_norms, rhat_window, r_mean_threshold,
        r_sigma_threshold, tail_avg_iters)
    if averaging:
        optimisation_log['averaged_variational_param'] = avg_params
    return (final_params[-1], host_chains, avg_means, avg_sigmas,
            value_history, log_norm_history, optimisation_log)


def rmsprop_IA_optimize_with_rhat(n_iters, objective_and_grad, init_param, K,
                                  *, generator=None, has_log_norm=None,
                                  window=500, learning_rate=.01,
                                  epsilon=.000001, rhat_window=500,
                                  averaging=True, n_optimisers=1,
                                  r_mean_threshold=1.15,
                                  r_sigma_threshold=1.20, tail_avg_iters=2000,
                                  learning_rate_end=None, mesh=None,
                                  checkpoint_path=None, save_every=1000,
                                  progress=False, device=None):
    """RMSProp with R-hat-gated iterate averaging over parallel chains
    (viabel_tpu/optimizers.py:845-900).

    The step is an EMA of squared gradients (alpha = 0.9) as the adaptive
    denominator; chain o >= 1 starts at ``init + 0.5 (o + 1) N(0, 1)``.
    The history records *pre-update* parameters, capped at ``100 *
    window`` iterates a chain (``window=None`` keeps all).  With
    ``averaging=True`` an online running mean of the post-update
    parameters from iteration ``n_iters // 1.3`` is kept and returned as
    ``optimisation_log['averaged_variational_param']`` ``(n_chains, P)``.

    From `generator` (default: seed 0 on `device`) come a seed for the
    init noise and one for each chain.  A presampled objective's chain o
    draws ``make_draws_range`` of a generator of its seed for the whole
    run (a Gaussian family's chains draw the same Philox rows on the CPU
    and on the card); an objective that samples inside its step draws
    chain o's iteration i from ``fold_in(seed_o, i)``, all chains in one
    batched step.  Runs on `device` (None: the CUDA card).

    With `checkpoint_path` and/or ``progress=True`` the run goes in
    `save_every`-iteration segments (`_chains_run_segmented`): the state
    is checkpointed after each (and resumed from `checkpoint_path` when it
    exists; the checkpoint's ``keys`` entry holds the chain generators'
    states at the start, and a checkpoint of another seed, shape or
    hyperparameter is refused), a running-average-loss line is printed,
    and a KeyboardInterrupt returns the histories so far.  A segmented run
    equals the whole run.

    With `mesh` (a `parallel.Mesh` whose ``chain`` axis divides
    `n_optimisers`) the chains split over its ``chain`` axis: each device
    group runs its chains as one batch on its device, from the same
    per-chain seeds (so the same draws, on the same kind of device), and
    every rank gathers the results; a checkpoint's carry returns to the
    groups' devices on resume.  `device` is then this rank's first device
    of the mesh.

    Returns the JAX package's 7-tuple of host numpy arrays:
    ``(variational_param, chains, averaged_means_list,
    averaged_sigmas_list, value_history, log_norm_history,
    optimisation_log)``; the first is the last chain's final iterate.
    """
    return _ia_optimize('rmsprop', 0.5, n_iters, objective_and_grad,
                        init_param, K, generator, has_log_norm, window,
                        learning_rate, epsilon, rhat_window, averaging,
                        n_optimisers, r_mean_threshold, r_sigma_threshold,
                        tail_avg_iters, learning_rate_end, mesh,
                        checkpoint_path, save_every, progress, device)


def adam_IA_optimize_with_rhat(n_iters, objective_and_grad, init_param, K,
                               *, generator=None, has_log_norm=None,
                               window=500, learning_rate=.01,
                               epsilon=.000001, rhat_window=500,
                               averaging=True, n_optimisers=1,
                               r_mean_threshold=1.15, r_sigma_threshold=1.20,
                               tail_avg_iters=2000, learning_rate_end=None,
                               mesh=None, checkpoint_path=None,
                               save_every=1000, progress=False,
                               device=None):
    """Adam with R-hat-gated iterate averaging over parallel chains
    (viabel_tpu/optimizers.py:903-932): moments with beta1 = 0.9,
    beta2 = 0.999, initialized at ``0.9 g`` / ``0.9 g^2`` and
    bias-corrected with power ``i + 2``; chain inits perturbed with scale
    0.2.  Everything else as `rmsprop_IA_optimize_with_rhat`."""
    return _ia_optimize('adam', 0.2, n_iters, objective_and_grad,
                        init_param, K, generator, has_log_norm, window,
                        learning_rate, epsilon, rhat_window, averaging,
                        n_optimisers, r_mean_threshold, r_sigma_threshold,
                        tail_avg_iters, learning_rate_end, mesh,
                        checkpoint_path, save_every, progress, device)


def rmsprop_IA_optimize(n_iters, objective_and_grad, init_param, K, *,
                        generator=None, has_log_norm=None, learning_rate=.01,
                        epsilon=.000001, n_optimisers=1, tail_avg_iters=2000,
                        learning_rate_end=None, device=None):
    """RMSProp with plain tail iterate averaging: an R-hat window longer
    than the run, so no window gates the start
    (viabel_tpu/optimizers.py:935-949)."""
    return rmsprop_IA_optimize_with_rhat(
        n_iters, objective_and_grad, init_param, K, generator=generator,
        has_log_norm=has_log_norm, learning_rate=learning_rate,
        epsilon=epsilon, n_optimisers=n_optimisers,
        tail_avg_iters=tail_avg_iters, learning_rate_end=learning_rate_end,
        rhat_window=max(n_iters, 1), device=device)


def adam_IA_optimize(n_iters, objective_and_grad, init_param, K, *,
                     generator=None, has_log_norm=None, learning_rate=.01,
                     epsilon=.000001, n_optimisers=1, tail_avg_iters=2000,
                     learning_rate_end=None, device=None):
    """Adam with plain tail iterate averaging (viabel_tpu/optimizers.py:
    952-963; see `rmsprop_IA_optimize`)."""
    return adam_IA_optimize_with_rhat(
        n_iters, objective_and_grad, init_param, K, generator=generator,
        has_log_norm=has_log_norm, learning_rate=learning_rate,
        epsilon=epsilon, n_optimisers=n_optimisers,
        tail_avg_iters=tail_avg_iters, learning_rate_end=learning_rate_end,
        rhat_window=max(n_iters, 1), device=device)
