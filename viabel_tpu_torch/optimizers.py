"""Windowed adagrad, and RMSProp/Adam with R-hat-gated iterate averaging.

PyTorch port of viabel_tpu/optimizers.py (42-165, 201-230, 245-349 for
adagrad; 352-487 and 721-962 for the iterate-averaging optimizers).
The JAX package compiles a whole adagrad run into one `lax.scan`.  Here
its state lives on the device and each iteration is the objective's value
and gradient followed by one hand-written step kernel
(`ops.adagrad.adagrad_step`) that reads the iteration from a counter on
the device; on the card a presampled objective's run is that body captured
in a CUDA graph and replayed, so no iteration waits for the host.  The IA
optimizers' chain step runs eagerly: a Python loop over iterations, the
learning rate a host float, nothing waiting for the device.  Their chains
are a batch dimension: one batched step an iteration through
``torch.func.vmap`` of the objective's gradient, as the JAX package vmaps
its scan.  The scan-unroll knob (`resolve_unroll`) tuned a
TPU compiler and has no counterpart here.  The segmented, checkpointed and
mesh-sharded chain runs come with a later slice.
"""
import torch

from ._device import default_generator, resolve_device
from .diagnostics import (compute_R_hat_adaptive, compute_R_hat_halfway,
                          stochastic_iterate_averaging)
from .ops.adagrad import adagrad_step
from .ops.adagrad import new_state as new_adagrad_state
from .ops.adagrad import replay as adagrad_replay
from .ops.gaussian_lw import philox_normal
from .ops.philox import philox_seed

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
    """Normalize to ``(value, grad, log_norm)``; objectives without a
    log-norm output get a zero one (viabel_tpu/optimizers.py:125-139)."""
    if has_log_norm is None:
        has_log_norm = getattr(objective_and_grad, 'has_log_norm', False)
    if has_log_norm:
        def obj(var_param, rng_or_draws):
            out = objective_and_grad(var_param, rng_or_draws)
            return out[0], out[1], out[2]
    else:
        def obj(var_param, rng_or_draws):
            value, grad = objective_and_grad(var_param, rng_or_draws)[:2]
            return value, grad, torch.zeros_like(value)
    obj.presampled = getattr(objective_and_grad, 'presampled', False)
    return obj


# iterations captured in one CUDA graph of the adagrad loop, chosen by
# measurement (tools/graph_depth.py, PERF.md): at 2000 iterations one
# iteration a graph ran fastest, since capturing an iteration costs the
# host what running it eagerly does and a replay costs less than the card
# spends on it; a one-iteration graph takes any remainder
_GRAPH_ITERS = 1


def _adagrad_iteration(obj, state, source):
    """One adagrad iteration on the device-side `state`
    (`ops.adagrad.AdagradState`): the objective's value and gradient at
    ``state.param``, cast to its dtype, then the step kernel.  A presampled
    objective takes the row of its ``(n_iters, n_mc, d)`` draws that the
    device counter names; any other takes the generator `source`.  Nothing
    in it waits for the device or decides on the host, so the same body
    runs eagerly and under capture."""
    xs = (source.index_select(0, state.counter)[0]
          if getattr(obj, 'presampled', False) else source)
    value, grad, log_norm = obj(state.param, xs)
    dtype = state.param.dtype
    adagrad_step(state, grad.to(dtype), value.to(dtype), log_norm.to(dtype))


def _adagrad_eager(obj, state, source, iters):
    """`iters` iterations of the body, one launch after another."""
    for _ in range(iters):
        _adagrad_iteration(obj, state, source)


def _adagrad_graph(obj, state, source, iters, window):
    """`iters` iterations of the body of a presampled objective on the
    card: the first `window` eagerly on a side stream (real iterations,
    which also warm up autograd's and the allocator's state and fill the
    model's device data cache), then the body captured `_GRAPH_ITERS`
    times in one CUDA graph and once in another, and those graphs replayed
    until the run is done.  A failed capture raises."""
    device = state.param.device
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    warm = min(window, iters)
    with torch.cuda.stream(side):
        _adagrad_eager(obj, state, source, warm)
    full, rest = divmod(iters - warm, _GRAPH_ITERS)
    graphs = []
    for count, steps in ((full, _GRAPH_ITERS), (rest, 1)):
        if count:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    _adagrad_eager(obj, state, source, steps)
                finally:
                    graph.capture_end()
            graphs.append((graph, steps, count))
    main.wait_stream(side)
    for graph, steps, count in graphs:
        for _ in range(count):
            adagrad_replay(graph, steps)


def _learning_rates(n_iters, learning_rate, learning_rate_end, dtype):
    """The schedule of every iteration as a tensor of `dtype`: Python
    floats rounded once to `dtype`, the value the eager step multiplied
    by."""
    return torch.tensor([learning_rate_schedule(i, n_iters, learning_rate,
                                                learning_rate_end)
                         for i in range(n_iters)],
                        dtype=torch.float64).to(dtype)


def _adagrad_run(obj, n_iters, window, learning_rate, epsilon,
                 learning_rate_end, init_param, draws, keep_history=True,
                 driver=None):
    """The whole adagrad run (viabel_tpu/optimizers.py:201-230, 241-303).

    `draws` is the ``(n_iters, n_mc, d)`` block of base draws for a
    presampled objective (row ``i`` feeds iteration ``i``), or a
    `torch.Generator` for an objective that samples itself.  The state of
    the run lives on the device (`ops.adagrad.AdagradState`) and one body
    (`_adagrad_iteration`) runs every iteration.  The driver is chosen by
    the objective's type and the device: a presampled objective on the card
    runs as a replayed CUDA graph (`_adagrad_graph`); an objective that
    samples from a generator, and any run on the CPU (with the plain step),
    run eagerly.  ``driver='eager'`` or ``'graph'`` names one instead (to
    compare the two); the graph takes presampled objectives on the card
    only.  The tail-quarter running sum is accumulated in both history
    modes, so the averaged parameter is the same whether or not the
    history is kept.

    Returns ``(values, log_norms, params, tail_mean)``; ``params`` is the
    ``(n_iters, P)`` iterate history, or None with ``keep_history=False``.
    """
    presampled = getattr(obj, 'presampled', False)
    on_card = init_param.device.type == 'cuda'
    if driver is None:
        driver = 'graph' if presampled and on_card else 'eager'
    if driver == 'graph' and not (presampled and on_card):
        raise ValueError('the graph driver runs presampled objectives on the '
                         'card only')
    if driver not in ('eager', 'graph'):
        raise ValueError('driver must be None, "eager" or "graph"')
    state = new_adagrad_state(
        init_param, _learning_rates(n_iters, learning_rate,
                                    learning_rate_end, init_param.dtype),
        window, epsilon, keep_history)
    if driver == 'graph':
        _adagrad_graph(obj, state, draws, n_iters, window)
    else:
        _adagrad_eager(obj, state, draws, n_iters)
    if int(state.counter) != n_iters:
        raise RuntimeError('the adagrad run stopped at iteration {} of {}'
                           .format(int(state.counter), n_iters))
    tail_mean = state.tail_sum / (n_iters - state.tail_start)
    return state.values, state.log_norms, state.params, tail_mean


def adagrad_optimize(n_iters, objective_and_grad, init_param, *,
                     generator=None, has_log_norm=None, window=10,
                     learning_rate=.01, epsilon=.1, learning_rate_end=None,
                     return_history=True, device=None, draws=None):
    """Windowed adagrad with min-log-norm gradient rescaling and
    tail-quarter iterate averaging (viabel_tpu/optimizers.py:306-349).

    Returns ``(smoothed_opt_param, variational_param_history,
    value_history, log_norm_history)``; the parameter history covers the
    last quarter of the iterations, and is None with
    ``return_history=False``.  Runs on `device` (None: the CUDA card);
    `generator` defaults to seed 0 on that device.  A presampled objective
    draws its ``(n_iters, n_mc, d)`` block from `generator`, or takes it
    as `draws` (e.g. `interop.presampled_draws` of the JAX package's).
    """
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = torch.as_tensor(init_param, device=device)
    if not obj.presampled:
        if draws is not None:
            raise ValueError('draws= feeds a presampled objective only')
        draws = generator
    elif draws is None:
        draws = objective_and_grad.make_draws(generator, n_iters,
                                              init_param.dtype)
    values, log_norms, params, tail_mean = _adagrad_run(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, draws, keep_history=return_history)
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


def _batched_step(objective_and_grad, has_log_norm):
    """``step(params (C, P), draws (C, n_mc, d)) -> (values (C,), grads
    (C, P), log_norms (C,))``: the objective's value and gradient for every
    chain in one batched call (``vmap`` of ``grad_and_value`` over the
    objective's pure function, the counterpart of the JAX package's vmapped
    scan).  Objectives with a log-norm output come with a later slice."""
    if has_log_norm is None:
        has_log_norm = getattr(objective_and_grad, 'has_log_norm', False)
    objective = getattr(objective_and_grad, 'objective', None)
    if has_log_norm or objective is None:
        raise NotImplementedError(
            'the IA optimizers batch chains through the pure '
            '`objective_and_grad.objective` of a KLVI objective; objectives '
            'with a log-norm output are not ported yet')
    value_and_grad = torch.func.vmap(torch.func.grad_and_value(objective))

    def step(params, draws):
        grad, value = value_and_grad(params, draws)
        return value, grad, torch.zeros_like(value)

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
    chain, ``(n_chains, length, n_mc, d)``: one block per chain from its
    generator (viabel_tpu/optimizers.py:420-426)."""
    return torch.stack([obj.make_draws_range(g, i0, length, dtype)
                        for g in chain_generators])


def _chains_run(step, kind, n_iters, learning_rate, epsilon,
                learning_rate_end, inits, draws, hist_cap=None,
                avg_start=None):
    """Every chain's run, one batched step an iteration
    (viabel_tpu/optimizers.py:429-487).

    `step` is `_batched_step`'s function, `inits` the ``(C, P)`` chain
    inits and `draws` the ``(C, n_iters, n_mc, d)`` presampled block.  The
    history entry of iteration i is the *pre-update* parameter.  With
    `hist_cap` below `n_iters` the history is a ``(C, hist_cap, P)`` ring
    buffer, returned in chronological order.  With `avg_start` an online
    running mean of the post-update parameters over iterations
    ``i > avg_start`` is kept.  Returns ``((values, log_norms, chains),
    final_params, avg_params)``.
    """
    C, P = inits.shape
    dtype, device = inits.dtype, inits.device
    kept = hist_cap if hist_cap is not None and hist_cap < n_iters \
        else n_iters
    chains = torch.empty((C, kept, P), dtype=dtype, device=device)
    values = torch.empty((C, n_iters), dtype=dtype, device=device)
    log_norms = torch.empty((C, n_iters), dtype=dtype, device=device)
    param = inits.clone()
    v = m = avg = torch.zeros_like(param)
    for i in range(n_iters):
        value, grad, log_norm = step(param, draws[:, i])
        chains[:, i % kept] = param
        values[:, i] = value
        log_norms[:, i] = log_norm
        new_param, v, m = _chain_step(
            kind, i, n_iters, learning_rate, epsilon, learning_rate_end,
            param, grad.to(dtype), v, m)
        if avg_start is not None:
            avg = (avg + (new_param - avg) / max(i - avg_start, 1)
                   if i > avg_start else new_param)
        param = new_param
    if kept < n_iters:
        chains = torch.roll(chains, -(n_iters % kept), dims=1)
    return (values, log_norms, chains), param, avg


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
    (viabel_tpu/optimizers.py:792-842)."""
    for name, value in (('mesh', mesh), ('checkpoint_path', checkpoint_path),
                        ('save_every', save_every)):
        if value is not None:
            raise NotImplementedError(
                '{}= is not ported yet: segmented, checkpointed and sharded '
                'chain runs come with a later slice'.format(name))
    if progress:
        raise NotImplementedError('progress=True is not ported yet')
    if not getattr(objective_and_grad, 'presampled', False):
        raise NotImplementedError(
            'the IA optimizers take a presampled objective '
            '(black_box_klvi(..., presampled=True)); objectives that draw '
            'from a generator inside the step are not ported yet')
    step = _batched_step(objective_and_grad, has_log_norm)
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
    draws = _chain_xs(objective_and_grad, chain_generators, 0, n_iters,
                      dtype)
    # history cap: at most 100 * window iterates a chain; online tail
    # average from n_iters // 1.3 (viabel_tpu/optimizers.py:812-817)
    hist_cap = 100 * window if window is not None else None
    avg_start = int(n_iters // 1.3) if averaging else None
    (values, log_norms, chains), final_params, avg_params = _chains_run(
        step, kind, n_iters, learning_rate, epsilon, learning_rate_end,
        inits, draws, hist_cap, avg_start)
    (avg_means, avg_sigmas, value_history, log_norm_history,
     optimisation_log, host_chains) = _ia_postprocess(
        K, chains.cpu().numpy(), values.cpu().numpy(),
        log_norms.cpu().numpy(), rhat_window, r_mean_threshold,
        r_sigma_threshold, tail_avg_iters)
    if averaging:
        optimisation_log['averaged_variational_param'] = \
            avg_params.cpu().numpy()
    return (final_params[-1].cpu().numpy(), host_chains, avg_means,
            avg_sigmas, value_history, log_norm_history, optimisation_log)


def rmsprop_IA_optimize_with_rhat(n_iters, objective_and_grad, init_param, K,
                                  *, generator=None, has_log_norm=None,
                                  window=500, learning_rate=.01,
                                  epsilon=.000001, rhat_window=500,
                                  averaging=True, n_optimisers=1,
                                  r_mean_threshold=1.15,
                                  r_sigma_threshold=1.20, tail_avg_iters=2000,
                                  learning_rate_end=None, mesh=None,
                                  checkpoint_path=None, save_every=None,
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

    `objective_and_grad` must be presampled; chain o's draws are
    ``make_draws_range`` of a generator seeded from `generator` (default:
    seed 0 on `device`), so a Gaussian family's chains draw the same
    Philox rows on the CPU and on the card.  Runs on `device` (None: the
    CUDA card).  `mesh`, `checkpoint_path`, `save_every` and `progress`
    raise NotImplementedError.

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
                               save_every=None, progress=False, device=None):
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
