"""Plain CHIVI (Dieng et al. 2017) under the min-rescaled windowed
adagrad, as validated VI fits it (arXiv:1910.04102): the reference of a
configuration whose ``objective`` is ``chivi``.

Plain PyTorch in `vi`'s style, written from the definitions and importing
nothing of the program.  For a location-scale mean-field q (``x = m +
exp(s) t``, `vi.MeanFieldT`) the log-weight ``lw = log p(x) - log q(x)``
has the reparameterisation gradient ``d lw / d m = g`` and ``d lw / d s =
g t exp(s) + 1``, with ``g = grad log p(x)``: at ``x = m + exp(s) t``,
``log q(x)`` is ``sum log f(t) - s``, which depends on m not at all and
on s through ``-s`` alone.
"""
import torch

from . import vi


def value_grad_and_log_norm(fam, p, t, log_p, grad_log_p, alpha):
    """CHIVI at `p` on the base draws `t` (n, d): the CUBO ``log mean w /
    alpha + log_norm``, its gradient ``alpha / n sum_i w_i grad lw_i`` with
    the weights ``w = exp(alpha (lw - log_norm))`` held constant, and the
    log-norm ``max lw``."""
    s = fam.split(p)[1]
    x = fam.transform(p, t)
    lw = log_p(x) - fam.log_q(p, x)
    log_norm = torch.max(lw)
    w = torch.exp(alpha * (lw - log_norm))
    scale = alpha / t.shape[-2]
    g = grad_log_p(x)
    grad = torch.cat([scale * (w @ g),
                      scale * (w @ (g * t * torch.exp(s) + 1.0))])
    return torch.log(torch.mean(w)) / alpha + log_norm, grad, log_norm


def adagrad(step, init, lrs, window, epsilon):
    """Windowed adagrad with the min-rescaled window (viabel's
    ``adagrad_optimize``): ``step(param, i)`` gives iteration i's gradient
    and log-norm; the denominator sums the squares of the window's
    gradients, each scaled by ``exp(min log_norm - log_norm_j)`` over the
    slots filled so far, and the update takes the current gradient
    unscaled.  Returns the mean of the iterates over the last quarter of
    the run and the log-norm of every iteration."""
    n = len(lrs)
    p = init.clone()
    ring = torch.zeros((window,) + tuple(p.shape), dtype=p.dtype,
                       device=p.device)
    ring_log_norms = torch.zeros(window, dtype=p.dtype, device=p.device)
    log_norms = torch.zeros(n, dtype=p.dtype, device=p.device)
    tail, tail_start = torch.zeros_like(p), 3 * n // 4
    for i in range(n):
        g, log_norm = step(p, i)
        ring[i % window] = g
        ring_log_norms[i % window] = log_norm
        log_norms[i] = log_norm
        filled = ring_log_norms[:min(i + 1, window)]
        scale = torch.exp(torch.min(filled) - filled)
        acc = torch.sum((scale[:, None] * ring[:len(filled)]) ** 2, dim=0)
        p = p - lrs[i] * g / torch.sqrt(epsilon + acc)
        if i >= tail_start:
            tail = tail + p
    return tail / (n - tail_start), log_norms


def fit(ref, seed, init):
    """`validated_vi` with a CHIVI objective from a generator of `seed`,
    as `protocols.Reference.fit` replays KLVI: the optimizer's raw draws
    (``ref._opt_draws``), then the bound pass's base draws, the optimizer
    in ``ref.work`` on the reference's optimizer device, and the bound
    pass (``ref.bound_pass``).  The result carries the run's
    ``log_norms`` besides."""
    cfg = ref.cfg
    gen = vi.generator(seed, ref.device)
    draws = ref._opt_draws(gen)
    z = ref.fam.draws(gen, cfg['n_bound_samples'], ref.work, ref.device)
    target = ref.opt_target

    def step(p, i):
        _, grad, log_norm = value_grad_and_log_norm(
            ref.fam, p, draws[i], target.log_p, target.grad, cfg['alpha'])
        return grad, log_norm

    lrs = vi.learning_rates(cfg['n_iters'], cfg['learning_rate'],
                            cfg['learning_rate_end'])
    param, log_norms = adagrad(step, init.to(ref.opt_device, ref.work), lrs,
                               cfg['window'], cfg['epsilon'])
    del draws
    return dict(param=param, log_norms=log_norms, **ref.bound_pass(param, z))
