"""Windowed adagrad with tail-quarter iterate averaging.

PyTorch port of the adagrad part of viabel_tpu/optimizers.py (42-165,
201-230, 245-349).  PyTorch runs eagerly, so the JAX package's compiled
`lax.scan` becomes a Python loop over iterations; the learning-rate
schedule is a host float per iteration, and nothing in the loop waits for
the device.  The scan-unroll knob (`resolve_unroll`) tuned a TPU compiler
and has no counterpart here.

The IA optimizers (RMSProp/Adam with R-hat) come with a later slice.
"""
import torch

from ._device import default_generator, resolve_device

__all__ = ['learning_rate_schedule', 'adagrad_optimize']


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


def _window_accum(grads, log_norms, i, grad, log_norm):
    """Insert (grad, log_norm) into the ring buffers IN PLACE and return
    ``sum_valid (exp(min log_norm - log_norm) * grad)^2``, the
    min-rescaled windowed adagrad denominator
    (viabel_tpu/optimizers.py:142-165).  The first ``min(i + 1, window)``
    slots are the filled ones."""
    window = grads.shape[0]
    slot = i % window
    grads[slot] = grad
    log_norms[slot] = log_norm
    k = min(i + 1, window)
    ln = log_norms[:k]
    scale = torch.exp(torch.min(ln) - ln)
    return torch.sum((scale[:, None] * grads[:k]) ** 2, dim=0)


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


def _adagrad_run(obj, n_iters, window, learning_rate, epsilon,
                 learning_rate_end, init_param, draws, keep_history=True):
    """The whole adagrad run (viabel_tpu/optimizers.py:201-230, 241-303).

    `draws` is the ``(n_iters, n_mc, d)`` block of base draws for a
    presampled objective (row ``i`` feeds iteration ``i``), or a
    `torch.Generator` for an objective that samples itself.  The
    tail-quarter running sum is accumulated in both modes, so the averaged
    parameter is the same whether or not the history is kept.

    Returns ``(values, log_norms, params, tail_mean)``; ``params`` is the
    ``(n_iters, P)`` iterate history, or None with ``keep_history=False``.
    """
    param = init_param.detach().clone()
    dtype, device = param.dtype, param.device
    P = param.shape[0]
    presampled = getattr(obj, 'presampled', False)
    grads = torch.zeros((window, P), dtype=dtype, device=device)
    log_norm_buf = torch.zeros((window,), dtype=dtype, device=device)
    values = torch.empty((n_iters,), dtype=dtype, device=device)
    log_norms = torch.empty((n_iters,), dtype=dtype, device=device)
    params = (torch.empty((n_iters, P), dtype=dtype, device=device)
              if keep_history else None)
    tail_start = 3 * n_iters // 4
    tail_sum = torch.zeros((P,), dtype=dtype, device=device)
    for i in range(n_iters):
        value, grad, log_norm = obj(param, draws[i] if presampled else draws)
        grad = grad.to(dtype)
        log_norm = log_norm.to(dtype)
        accum_sum = _window_accum(grads, log_norm_buf, i, grad, log_norm)
        lr = learning_rate_schedule(i, n_iters, learning_rate,
                                    learning_rate_end)
        param = param - lr * grad / torch.sqrt(epsilon + accum_sum)
        values[i] = value
        log_norms[i] = log_norm
        if keep_history:
            params[i] = param
        if i >= tail_start:
            tail_sum += param
    tail_mean = tail_sum / (n_iters - tail_start)
    return values, log_norms, params, tail_mean


def adagrad_optimize(n_iters, objective_and_grad, init_param, *,
                     generator=None, has_log_norm=None, window=10,
                     learning_rate=.01, epsilon=.1, learning_rate_end=None,
                     return_history=True, device=None):
    """Windowed adagrad with min-log-norm gradient rescaling and
    tail-quarter iterate averaging (viabel_tpu/optimizers.py:306-349).

    Returns ``(smoothed_opt_param, variational_param_history,
    value_history, log_norm_history)``; the parameter history covers the
    last quarter of the iterations, and is None with
    ``return_history=False``.  Runs on `device` (None: the CUDA card);
    `generator` defaults to seed 0 on that device.
    """
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = torch.as_tensor(init_param, device=device)
    draws = generator
    if obj.presampled:
        draws = objective_and_grad.make_draws(generator, n_iters,
                                              init_param.dtype)
    values, log_norms, params, tail_mean = _adagrad_run(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, draws, keep_history=return_history)
    tail = params[3 * n_iters // 4:] if return_history else None
    return tail_mean, tail, values, log_norms
