"""Variational objectives with autograd gradients.

PyTorch port of viabel_tpu/objectives.py:50-125 and 177-222 (KLVI and
CHIVI).  Each factory returns ``objective_and_grad(var_param,
rng_or_draws) -> (value, grad)`` (CHIVI adds a third output, the
log-norm); the gradient is a reparameterization gradient from
`torch.autograd.grad`.
With ``presampled=True`` the objective consumes pre-generated base draws
instead of a generator, and carries ``make_draws`` to produce them in one
batch for a whole optimizer run, and ``make_draws_range`` to produce any
range of iterations' draws of one stream (the IA optimizers' per-chain
blocks).

The path-derivative KLVI variants, `black_box_chivi_neff`,
`perturbed_black_box_vi` and `vectorize_log_density` come with a later
slice.
"""
import torch

from .ops.gaussian_lw import philox_normal

__all__ = ['black_box_klvi', 'black_box_chivi']


def _attach_presampling(fn, var_family, n_samples):
    """Mark `fn` as consuming pre-generated base draws and give it batched
    draw generators (viabel_tpu/objectives.py:50-73).

    ``make_draws(generator, n_iters, dtype)`` returns one
    ``(n_iters, n_samples, dim)`` block drawn in a single call on the
    generator's device; row ``i`` feeds iteration ``i``.

    ``make_draws_range(generator, start, length, dtype)`` returns the rows
    of iterations ``[start, start + length)`` of the stream that the
    generator's initial seed names: it reads the generator as a key and
    does not advance it, and row ``i`` is the same whatever range it is
    drawn in, as the JAX package's ``fold_in(key, i)`` rows are.  The
    Gaussian family's rows come from the Philox stream
    (`ops.gaussian_lw.philox_normal`; key the initial seed, offset 0, row
    i's draw j is sample ``i * n_samples + j``), so the CPU and the card
    draw the same rows.  Other families draw from a fresh generator of
    that seed, and only from ``start = 0``.
    """
    fn.presampled = True

    def make_draws(generator, n_iters, dtype=torch.float32):
        flat = var_family.base_sample(generator, n_iters * n_samples, dtype)
        return flat.reshape(n_iters, n_samples, -1)

    def make_draws_range(generator, start, length, dtype=torch.float32):
        seed = generator.initial_seed()
        if var_family.name == 'mf_gaussian':
            flat = philox_normal(length * n_samples, var_family.dim, seed,
                                 0, start * n_samples, dtype,
                                 generator.device)
            return flat.reshape(length, n_samples, -1)
        if start != 0:
            raise NotImplementedError(
                'draws from iteration {} on need a counter-based stream, '
                'which only the Gaussian family has'.format(start))
        fresh = torch.Generator(device=generator.device).manual_seed(seed)
        return make_draws(fresh, length, dtype)

    fn.make_draws = make_draws
    fn.make_draws_range = make_draws_range
    return fn


def _sample_or_transform(var_family, n_samples, presampled, var_param,
                         rng_or_draws):
    """Samples for one objective evaluation
    (viabel_tpu/objectives.py:105-125)."""
    if presampled:
        if (not isinstance(rng_or_draws, torch.Tensor)
                or not rng_or_draws.is_floating_point()):
            raise TypeError(
                'this objective was built with presampled=True and consumes '
                'pre-generated base draws (a floating-point tensor), but '
                'received {}. Optimizers feed draws automatically '
                '(obj.make_draws); for direct calls pass '
                'var_family.base_sample(generator, n_samples), or rebuild '
                'the objective with presampled=False to consume '
                'generators'.format(type(rng_or_draws).__name__))
        return var_family.transform(var_param, rng_or_draws)
    return var_family.sample(rng_or_draws, var_param, n_samples)


def black_box_klvi(var_family, log_density, n_samples, presampled=False):
    """KLVI objective ``-ELBO`` with the closed-form entropy
    (viabel_tpu/objectives.py:76-102).

    `log_density` maps a batch ``(n, d)`` to ``(n,)`` log densities.
    """

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        lower_bound = (var_family.entropy(var_param)
                       + torch.mean(log_density(samples)))
        return -lower_bound

    def objective_and_grad(var_param, rng_or_draws):
        with torch.enable_grad():
            p = var_param.detach().requires_grad_(True)
            value = objective(p, rng_or_draws)
            grad, = torch.autograd.grad(value, p)
        return value.detach(), grad

    objective_and_grad.has_log_norm = False
    objective_and_grad.objective = objective
    if presampled:
        _attach_presampling(objective_and_grad, var_family, n_samples)
    return objective_and_grad


def black_box_chivi(alpha, var_family, log_density, n_samples,
                    presampled=False):
    """CHIVI objective: the exponentiated CUBO
    (viabel_tpu/objectives.py:177-222).

    Returns ``(cubo, grad, log_norm)`` with ``log_norm = max lw``, the
    rescaling the windowed adagrad uses when run with ``has_log_norm``.
    The gradient is ``alpha J^T w / n`` with ``w = exp(lw - max lw)^alpha``
    held constant: the vector-Jacobian product of the log-weights with a
    detached cotangent, as the JAX package's ``jax.vjp`` with a stopped
    cotangent; the CUBO value is not differentiated.  The naive Monte Carlo
    CUBO degenerates once the log-weights spread over more than a few nats
    (from d = 30 up in the JAX package's measurements): use it at small d.
    """

    def compute_log_weights(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        return log_density(samples) - var_family.log_prob(var_param, samples)

    def objective_grad_and_log_norm(var_param, rng_or_draws):
        with torch.enable_grad():
            p = var_param.detach().requires_grad_(True)
            log_weights = compute_log_weights(p, rng_or_draws)
            lw = log_weights.detach()
            log_norm = torch.max(lw)
            scaled_values = torch.exp(lw - log_norm) ** alpha
            value = torch.log(torch.mean(scaled_values)) / alpha + log_norm
            vjp, = torch.autograd.grad(log_weights, p,
                                       grad_outputs=scaled_values)
        return value, alpha * vjp / scaled_values.numel(), log_norm

    objective_grad_and_log_norm.has_log_norm = True
    objective_grad_and_log_norm.compute_log_weights = compute_log_weights
    if presampled:
        _attach_presampling(objective_grad_and_log_norm, var_family,
                            n_samples)
    return objective_grad_and_log_norm
