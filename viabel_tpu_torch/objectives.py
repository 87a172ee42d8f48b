"""Variational objectives with autograd gradients.

PyTorch port of viabel_tpu/objectives.py.  Each factory returns
``objective_and_grad(var_param, rng_or_draws) -> (value, grad)`` (CHIVI
adds a third output, the log-norm, and `black_box_chivi_neff` a fourth,
n_eff); the gradient is a reparameterization gradient.
With ``presampled=True`` the objective consumes pre-generated base draws
instead of a generator, and carries ``make_draws`` to produce them in one
batch for a whole optimizer run, and ``make_draws_range`` to produce any
range of iterations' draws of one stream (the IA optimizers' per-chain
blocks).  A family whose base draws are a dict of tensors (the full-rank
Student-t family's ``{'z', 'chi2'}``) gets its draws as a dict of blocks.

An objective built with ``presampled=False`` samples from the generator
it is given; given base draws instead, it transforms them, which is how
the IA optimizers' batched chain step feeds it each chain's draws of an
iteration (``iteration_draws(generator, dtype)``, the ``(n_samples,
...)`` base draws that sampling from `generator` would transform).

Every objective carries ``has_log_norm``, and ``host_callback``: whether
its log density is a host-side one (`models.external`), which the
optimizers never capture in a CUDA graph.  Presampled `black_box_klvi` and
`black_box_chivi` of a mean-field family on an eight-schools density also
carry ``fused``, the hand-written body that the optimizers run in their
place on the card (`ops.klvi_mf`, `ops.chivi_mf`; None elsewhere).  The
KLVI forms carry their pure scalar ``objective(var_param, draws)``, whose
gradient the batched optimizers take with ``torch.func.grad_and_value``;
the CHIVI forms carry ``compute_log_weights`` and are themselves
`torch.func`-transformable (the gradient a `torch.func.vjp` of the
log-weights with a cotangent held constant), so the batched optimizers
vmap them.
"""
import torch

from .models.external import is_host_callback
from .ops.chivi_mf import fused_chivi
from .ops.gaussian_lw import philox_normal
from .ops.klvi_mf import fused_klvi

__all__ = ['black_box_klvi', 'black_box_klvi_pd', 'black_box_klvi_pd2',
           'black_box_chivi', 'black_box_chivi_neff',
           'perturbed_black_box_vi', 'vectorize_log_density']


def vectorize_log_density(log_density):
    """Lift a one-point log density ``f(x (d,)) -> scalar`` to batches
    ``(n, d) -> (n,)`` with `torch.func.vmap`
    (viabel_tpu/objectives.py:34-47); a ``(d,)`` input is passed through
    unbatched."""
    batched = torch.func.vmap(log_density)

    def wrapped(x):
        if x.dim() == 1:
            return log_density(x)
        return batched(x)

    return wrapped


def map_draws(fn, draws):
    """``fn`` applied to a tensor of draws, or to each tensor of a dict of
    them, nested dicts included (the full-rank Student-t family's ``{'z',
    'chi2'}``; a perturbed objective's ``{'noise', 'draws'}``)."""
    if isinstance(draws, dict):
        return {k: map_draws(fn, v) for k, v in draws.items()}
    return fn(draws)


def stack_draws(blocks):
    """Stack a list of draws along a new leading axis, entry by entry for
    dict draws (nested dicts included)."""
    if isinstance(blocks[0], dict):
        return {k: stack_draws([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def _attach_draws(fn, var_family, n_samples):
    """Give `fn` ``iteration_draws(generator, dtype)``: one evaluation's
    base draws, those that sampling from `generator` transforms
    (``var_family.sample(g, p, n) == transform(p, base_sample(g, n))``)."""
    def iteration_draws(generator, dtype=torch.float32):
        return var_family.base_sample(generator, n_samples, dtype)

    fn.iteration_draws = iteration_draws
    return fn


def _attach_presampling(fn, var_family, n_samples):
    """Mark `fn` as consuming pre-generated base draws and give it batched
    draw generators (viabel_tpu/objectives.py:50-73).

    ``make_draws(generator, n_iters, dtype)`` returns one
    ``(n_iters, n_samples, dim)`` block (a dict of such blocks for a
    family with dict draws, each entry with the leading ``(n_iters,
    n_samples)``) drawn in a single call on the generator's device; row
    ``i`` feeds iteration ``i``.

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
        return map_draws(
            lambda v: v.reshape(n_iters, n_samples, *v.shape[1:]), flat)

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
    (viabel_tpu/objectives.py:105-125): a presampled objective transforms
    the base draws it is given and refuses anything else; any other samples
    from a generator, or transforms base draws given in its place."""
    if presampled:
        leaves = (list(rng_or_draws.values())
                  if isinstance(rng_or_draws, dict) else [rng_or_draws])
        if not all(isinstance(v, torch.Tensor) and v.is_floating_point()
                   for v in leaves):
            raise TypeError(
                'this objective was built with presampled=True and consumes '
                'pre-generated base draws (floating-point tensors), but '
                'received {}. Optimizers feed draws automatically '
                '(obj.make_draws); for direct calls pass '
                'var_family.base_sample(generator, n_samples), or rebuild '
                'the objective with presampled=False to consume '
                'generators'.format(type(rng_or_draws).__name__))
        return var_family.transform(var_param, rng_or_draws)
    if not isinstance(rng_or_draws, torch.Generator):
        return var_family.transform(var_param, rng_or_draws)
    return var_family.sample(rng_or_draws, var_param, n_samples)


def _klvi_objective(objective, presampled, var_family, n_samples,
                    log_density):
    """``objective_and_grad`` of a pure scalar `objective` of
    `log_density`: its value and its gradient by `torch.autograd.grad`,
    with the attributes the optimizers read."""

    def objective_and_grad(var_param, rng_or_draws):
        with torch.enable_grad():
            p = var_param.detach().requires_grad_(True)
            value = objective(p, rng_or_draws)
            grad, = torch.autograd.grad(value, p)
        return value.detach(), grad

    objective_and_grad.has_log_norm = False
    objective_and_grad.objective = objective
    objective_and_grad.host_callback = is_host_callback(log_density)
    _attach_draws(objective_and_grad, var_family, n_samples)
    if presampled:
        _attach_presampling(objective_and_grad, var_family, n_samples)
    return objective_and_grad


def black_box_klvi(var_family, log_density, n_samples, presampled=False):
    """KLVI objective ``-ELBO`` with the closed-form entropy
    (viabel_tpu/objectives.py:76-102).

    `log_density` maps a batch ``(n, d)`` to ``(n,)`` log densities (use
    `vectorize_log_density` for a one-point density).  Presampled, on a
    mean-field family and an eight-schools `models.Model`, the objective
    carries ``fused`` (`ops.klvi_mf.fused_klvi`): the value and gradient
    in one kernel, which the adagrad runs take on the card in place of
    this autograd body, its plain version.
    """

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        lower_bound = (var_family.entropy(var_param)
                       + torch.mean(log_density(samples)))
        return -lower_bound

    objective_and_grad = _klvi_objective(objective, presampled, var_family,
                                         n_samples, log_density)
    objective_and_grad.fused = (fused_klvi(objective, var_family,
                                           log_density)
                                if presampled else None)
    return objective_and_grad


def black_box_klvi_pd(var_family, log_density, n_samples, presampled=False):
    """KLVI with a Monte Carlo entropy, ``-(E[log p] - E[log q])``, the
    gradient through every path (viabel_tpu/objectives.py:128-143)."""

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        lower_bound = (torch.mean(log_density(samples))
                       - torch.mean(var_family.log_prob(var_param, samples)))
        return -lower_bound

    return _klvi_objective(objective, presampled, var_family, n_samples,
                           log_density)


def black_box_klvi_pd2(var_family, log_density, n_samples,
                       presampled=False):
    """The path-derivative ("sticking the landing") KLVI estimator
    (viabel_tpu/objectives.py:146-174): as `black_box_klvi_pd`, with the
    density's parameters detached in ``log q``, so the score-function path
    drops out of the gradient (Roeder et al. 2017)."""

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        frozen = var_param.detach()
        lower_bound = (torch.mean(log_density(samples))
                       - torch.mean(var_family.log_prob(frozen, samples)))
        return -lower_bound

    return _klvi_objective(objective, presampled, var_family, n_samples,
                           log_density)


def _chivi(alpha, var_family, log_density, n_samples, presampled, neff):
    """The CHIVI objective, with the n_eff-scaled gradient when `neff`."""

    def compute_log_weights(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        return log_density(samples) - var_family.log_prob(var_param, samples)

    def value_grad_and_log_norm(var_param, rng_or_draws):
        log_weights, vjp_fn = torch.func.vjp(
            lambda p: compute_log_weights(p, rng_or_draws),
            var_param.detach())
        log_norm = torch.max(log_weights)
        scaled_values = torch.exp(log_weights - log_norm) ** alpha
        value = torch.log(torch.mean(scaled_values)) / alpha + log_norm
        # the cotangent is a value of the primal, so it is held constant
        vjp, = vjp_fn(scaled_values)
        n = scaled_values.shape[-1]
        if not neff:
            return value, alpha * vjp / n, log_norm
        n_eff = (torch.sum(scaled_values) ** 2
                 / torch.sum(scaled_values ** 2))
        return value, alpha * vjp * n_eff / (n * n), log_norm, n_eff

    value_grad_and_log_norm.has_log_norm = True
    value_grad_and_log_norm.host_callback = is_host_callback(log_density)
    value_grad_and_log_norm.compute_log_weights = compute_log_weights
    value_grad_and_log_norm.fused = (
        fused_chivi(value_grad_and_log_norm, alpha, var_family, log_density)
        if presampled and not neff else None)
    _attach_draws(value_grad_and_log_norm, var_family, n_samples)
    if presampled:
        _attach_presampling(value_grad_and_log_norm, var_family, n_samples)
    return value_grad_and_log_norm


def black_box_chivi(alpha, var_family, log_density, n_samples,
                    presampled=False):
    """CHIVI objective: the exponentiated CUBO
    (viabel_tpu/objectives.py:177-222).

    Returns ``(cubo, grad, log_norm)`` with ``log_norm = max lw``, the
    rescaling the windowed adagrad uses when run with ``has_log_norm``.
    The gradient is ``alpha J^T w / n`` with ``w = exp(lw - max lw)^alpha``
    held constant: the vector-Jacobian product (`torch.func.vjp`) of the
    log-weights with the weights as its cotangent, as the JAX package's
    ``jax.vjp`` with a stopped cotangent; the CUBO value is not
    differentiated.  The function is `torch.func`-transformable, so the
    batched optimizers vmap it.  Presampled, on a mean-field family and an
    eight-schools `models.Model`, it carries ``fused``
    (`ops.chivi_mf.fused_chivi`): value, gradient and log-norm in one
    kernel, which the adagrad runs take on the card in place of this
    autograd body, its plain version.  The naive Monte Carlo CUBO
    degenerates once the log-weights spread over more than a few nats (from
    d = 30 up in the JAX package's measurements): use it at small d.
    """
    return _chivi(alpha, var_family, log_density, n_samples, presampled,
                  False)


def black_box_chivi_neff(alpha, var_family, log_density, n_samples,
                         presampled=False):
    """CHIVI with the gradient scaled by ``n_eff / n``, ``n_eff = (sum
    w)^2 / sum w^2`` of the exponentiated weights
    (viabel_tpu/objectives.py:225-280): a full-ESS weight set gives the
    CHIVI gradient, one dominated by a few samples is damped toward zero.
    Returns ``(cubo, grad, log_norm, n_eff)``."""
    return _chivi(alpha, var_family, log_density, n_samples, presampled,
                  True)


def perturbed_black_box_vi(var_family, log_density, n_samples,
                           perturbation_scale=0.1):
    """KLVI at Gaussian-perturbed parameters, a smoothed objective
    (viabel_tpu/objectives.py:283-303).  Each evaluation draws from the
    generator, in this order, the standard-normal perturbation noise
    (P,) and then the base draws of the ``n_samples`` samples, and returns
    the KLVI value and gradient at ``var_param + perturbation_scale *
    noise``.  ``perturbed_objective(var_param, noise, draws)`` is the same
    objective as a pure function of both draws.
    ``iteration_draws(generator, dtype)`` draws ``{'noise', 'draws'}`` as
    an evaluation does (the JAX package splits iteration i's key into the
    noise's key and the sample key), and the objective given that dict in
    place of a generator evaluates `perturbed_objective` on it, which is
    how the IA optimizers' batched chain step feeds it."""

    def perturbed_objective(var_param, noise, draws):
        perturbed = var_param + perturbation_scale * noise
        samples = var_family.transform(perturbed, draws)
        lower_bound = (var_family.entropy(perturbed)
                       + torch.mean(log_density(samples)))
        return -lower_bound

    def iteration_draws(generator, dtype=torch.float32):
        noise = torch.randn((var_family.var_param_dim,), generator=generator,
                            dtype=dtype, device=generator.device)
        return dict(noise=noise, draws=var_family.base_sample(
            generator, n_samples, dtype))

    def objective(var_param, rng_or_drawn):
        drawn = (iteration_draws(rng_or_drawn, var_param.dtype)
                 if isinstance(rng_or_drawn, torch.Generator)
                 else rng_or_drawn)
        return perturbed_objective(var_param, drawn['noise'],
                                   drawn['draws'])

    objective_and_grad = _klvi_objective(objective, False, var_family,
                                         n_samples, log_density)
    objective_and_grad.perturbed_objective = perturbed_objective
    objective_and_grad.iteration_draws = iteration_draws
    return objective_and_grad
