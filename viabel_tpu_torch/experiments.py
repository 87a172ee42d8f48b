"""Experiment harness: optimize, check accuracy, draw and score, bound,
PSIS-correct.

PyTorch port of viabel_tpu/experiments.py:39-184 and 283-387 (the
reporting helpers, `get_samples_and_log_weights`, `psis_correction`,
`improve_with_psis`, and `run_experiment`: KLVI then CHIVI, each followed
by a bound pass and PSIS), `improve_with_psis_sharded` (the same PSIS
correction split over a mesh, `parallel`) and the plots of
viabel_tpu/experiments.py:215-278, which need matplotlib (imported when a
plot is drawn).

`draw_and_score` and `get_samples_and_log_weights` decide how a bound
pass scores its samples:

* a mean-field Gaussian family and a model whose `kernel` tag names a CUDA
  log density: `get_samples_and_log_weights` goes to K2
  (`ops.gaussian_lw`), which draws the base normals from the Philox stream
  of a seed taken from the generator inside the kernel; the samples, where
  a caller needs them, come from `ops.gaussian_lw.philox_normal` of the
  same stream;
* given base draws z (`draw_and_score`, as `validated_vi` passes them), a
  mean-field family and a kernel-tagged model go through K1
  (`ops.lw_stats`);
* anything else is scored by the plain composition
  ``log p(x) - log q(x)`` and reduced by the log-weight kernels.

The wrappers run the kernels on CUDA tensors and their plain versions on
CPU tensors, so a CPU run draws and scores what a card run does.
"""
import time

import numpy as np
import torch

from ._device import default_generator, resolve_device
from ._trace import span
from .bounds import all_bounds, family_moment_bounds
from .objectives import black_box_chivi, black_box_klvi
from .ops import gaussian_lw as _gaussian_ops
from .ops import lw_stats as _lw_ops
from .ops.philox import philox_seed
from .optimizers import adagrad_optimize
from .psis import psislw, weighted_moments
from .utils import format_seconds

__all__ = [
    'print_bounds', 'check_accuracy', 'check_approx_accuracy',
    'get_samples_and_log_weights', 'draw_and_score', 'psis_correction',
    'improve_with_psis', 'improve_with_psis_sharded', 'run_experiment',
    'plot_approx_and_exact_contours', 'plot_history',
    'plot_dist_to_opt_param',
]

# families whose transform is mean + exp(log_scale) * z with a base density
# the fused kernels know
_KERNEL_FAMILIES = ('mf_gaussian', 'mf_t')


def _print_table(title, rows):
    """Aligned label/value report (viabel_tpu/experiments.py:39-47)."""
    print(title)
    width = max((len(label) for label, _ in rows), default=0)
    for label, value in rows:
        print('    {label:<{w}}  {value:.3g}'.format(label=label,
                                                     value=float(value),
                                                     w=width))


def print_bounds(results):
    """Report the bounds present in an `all_bounds` result dict
    (viabel_tpu/experiments.py:50-64)."""
    rows = []
    for key, label in (('W2', '2-Wasserstein'), ('W1', '1-Wasserstein'),
                       ('d2', '2-divergence'), ('mean_error', 'mean error'),
                       ('std_error', 'stdev error')):
        if results.get(key) is not None:
            rows.append((label, results[key]))
    if results.get('cov_error') is not None:
        rows.append(('cov error', results['cov_error']))
        rows.append(('cov error (sqrt)', np.sqrt(results['cov_error'])))
    _print_table('Upper bounds on the approximation error:', rows)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def check_accuracy(true_mean, true_cov, approx_mean, approx_cov,
                   verbose=False, method=None):
    """Norm-based moment errors against ground truth: 2-norm mean and
    stdev errors, relative stdev error, spectral and nuclear covariance
    errors beside the true covariance's norms
    (viabel_tpu/experiments.py:67-102).  Takes tensors or arrays."""
    true_mean, approx_mean, true_cov, approx_cov = map(
        _host, (true_mean, approx_mean, true_cov, approx_cov))
    true_std = np.sqrt(np.diag(true_cov))
    approx_std = np.sqrt(np.diag(approx_cov))

    results = {} if method is None else {'method': method}
    results['mean_error'] = np.linalg.norm(true_mean - approx_mean)
    results['std_error'] = np.linalg.norm(true_std - approx_std)
    results['rel_std_error'] = np.linalg.norm(approx_std / true_std - 1)
    for suffix, order in (('2', 2), ('nuc', 'nuc')):
        results['cov_error_' + suffix] = np.linalg.norm(
            true_cov - approx_cov, ord=order)
        results['cov_norm_' + suffix] = np.linalg.norm(true_cov, ord=order)

    if verbose:
        print('approx mean   =', approx_mean)
        print('approx stdevs =', approx_std)
        print()
        _print_table('Moment errors vs ground truth:', [
            ('mean error', results['mean_error']),
            ('stdev error', results['std_error']),
            ('sqrt spectral cov error', np.sqrt(results['cov_error_2'])),
            ('sqrt spectral true-cov norm', np.sqrt(results['cov_norm_2'])),
        ])
    return results


def check_approx_accuracy(var_family, var_param, true_mean, true_cov,
                          verbose=False, name=None):
    """`check_accuracy` of the family's moments at `var_param`
    (viabel_tpu/experiments.py:105-110)."""
    mean, cov = var_family.mean_and_cov(torch.as_tensor(var_param))
    return check_accuracy(true_mean, true_cov, mean, cov, verbose, name)


def _draws_in_kernel(log_density, var_family):
    return (getattr(log_density, 'kernel', None) is not None
            and var_family.name == 'mf_gaussian')


def draw_and_score(log_density, var_family, var_param, z, alpha=2.0):
    """Samples, log-weights and their (5,) statistics tensor
    (`bounds.STAT_KEYS` order) for base draws `z` at `var_param`.

    The samples ``var_family.transform(var_param, z)`` are formed in torch
    in both branches; the fused kernel scores from z and never reads them.
    """
    with span('bound_pass', var_param.device):
        samples = var_family.transform(var_param, z)
        kernel = getattr(log_density, 'kernel', None)
        if kernel is not None and var_family.name in _KERNEL_FAMILIES:
            d = var_family.dim
            lw, stats = _lw_ops.transform_score_stats(
                z.contiguous(), var_param[:d].contiguous(),
                var_param[d:].contiguous(), kernel,
                log_density.kernel_data_like(z), df=var_family.df,
                alpha=alpha)
            return samples, lw, stats
        lw = log_density(samples) - var_family.log_prob(var_param, samples)
        return samples, lw, _lw_ops.lw_stats(lw.contiguous(), alpha)


def get_samples_and_log_weights(log_density, var_family, var_param,
                                n_samples, generator=None, device=None):
    """Draw ``n_samples`` samples of q and their log-weights
    ``log p - log q`` (viabel_tpu/experiments.py:127-139).  Returns
    ``(samples (n, d), log_weights (n,))`` on `device` (None: the CUDA
    card); `generator` (default: seed 0 there) is advanced.

    A mean-field Gaussian q of a kernel-tagged model draws from the
    Philox stream of a seed taken from `generator`: K2 scores it with the
    draws made in-kernel and `philox_normal` writes the same samples.
    Any other q draws ``var_family.base_sample(generator, n)``."""
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    var_param = torch.as_tensor(var_param, device=device)
    if _draws_in_kernel(log_density, var_family):
        d = var_family.dim
        seed = philox_seed(generator)
        lw, _ = _gaussian_ops.gaussian_sample_score_partials(
            var_param[:d].contiguous(), var_param[d:].contiguous(),
            n_samples, seed, 0, log_density.kernel,
            log_density.kernel_data_like(var_param))
        z = _gaussian_ops.philox_normal(n_samples, d, seed, 0, 0,
                                        var_param.dtype, device)
        return var_family.transform(var_param, z), lw
    z = var_family.base_sample(generator, n_samples, var_param.dtype)
    samples, lw, _ = draw_and_score(log_density, var_family, var_param, z)
    return samples, lw


def psis_correction(log_density, var_family, var_param, n_samples,
                    generator=None, device=None):
    """Samples (transposed, ``(d, n)``, as in the JAX package), their
    PSIS-smoothed log-weights and khat (viabel_tpu/experiments.py:142-148).
    """
    samples, log_weights = get_samples_and_log_weights(
        log_density, var_family, var_param, n_samples, generator, device)
    smoothed_log_weights, khat = psislw(log_weights)
    return samples.T, smoothed_log_weights, khat


def improve_with_psis(log_density, var_family, var_param, n_samples,
                      true_mean, true_cov, transform=None, verbose=False,
                      generator=None, device=None):
    """PSIS-corrected moment estimates and their accuracy against ground
    truth (viabel_tpu/experiments.py:151-184).  Returns ``(results with
    khat, approx_mean, approx_cov)``, the moments as numpy arrays.

    With no `transform` the weighted moments are computed on the device
    and only the d-sized results reach the host; a `transform` (a numpy
    function of the ``(d, n)`` sample matrix) takes the samples to the host
    first."""
    samples, slw, khat = psis_correction(log_density, var_family, var_param,
                                         n_samples, generator, device)
    return _psis_results(samples, slw, khat, true_mean, true_cov, transform,
                         verbose)


def _psis_results(samples, slw, khat, true_mean, true_cov, transform,
                  verbose):
    """`improve_with_psis`'s moments and report from the ``(d, n)`` samples
    and their smoothed log-weights."""
    if verbose:
        print('khat = {:.3g}'.format(float(khat)))
        print()
    if transform is None:
        approx_mean, approx_cov = weighted_moments(samples.T, slw)
        approx_mean, approx_cov = _host(approx_mean), _host(approx_cov)
    else:
        samples = transform(_host(samples))
        slw = _host(slw)
        slw = slw - np.max(slw)
        wts = np.exp(slw)
        wts = wts / np.sum(wts)
        approx_mean = np.sum(wts[np.newaxis, :] * samples, axis=1)
        c = samples - approx_mean[:, None]
        approx_cov = (wts[np.newaxis, :] * c) @ c.T
    res = check_accuracy(true_mean, true_cov, approx_mean, approx_cov,
                         verbose)
    res['khat'] = float(khat)
    return res, approx_mean, approx_cov


def improve_with_psis_sharded(log_density, var_family, var_param, n_samples,
                              true_mean, true_cov, mesh, verbose=False,
                              generator=None):
    """`improve_with_psis` split over the ``sample`` axis of `mesh`: each
    shard draws and scores its samples on its device, only the weight tail
    is gathered for the GPD fit, and the corrected moments are summed over
    shards (viabel_tpu/experiments.py:187-214).  The pass's seed is drawn
    from `generator` (default: seed 0 on this rank's first device of the
    mesh) as `get_samples_and_log_weights` draws it, so a mean-field
    Gaussian q of a kernel-tagged model scores the same draws as
    `improve_with_psis` with the same generator, each shard its rows of
    the stream.  Returns ``(results with khat, approx_mean, approx_cov)``
    in numpy."""
    from .parallel import (psislw_sharded, sharded_all_bounds,
                           sharded_psis_moments)
    home = mesh.home()
    if generator is None:
        generator = default_generator(home)
    var_param = torch.as_tensor(var_param, device=home)
    _, lw, samples = sharded_all_bounds(
        log_density, var_family, var_param, n_samples,
        philox_seed(generator), mesh,
        moment_bound_fn=family_moment_bounds(var_family, var_param),
        return_log_weights=True, return_samples=True)
    slw, khat = psislw_sharded(lw, mesh)
    mean, cov = sharded_psis_moments(samples, slw, mesh)
    if verbose:
        print('khat = {:.3g}'.format(float(khat)))
    mean, cov = _host(mean), _host(cov)
    res = check_accuracy(true_mean, true_cov, mean, cov, verbose)
    res['khat'] = float(khat)
    return res, mean, cov


def plot_approx_and_exact_contours(log_density, var_family, var_param,
                                   xlim=(-10, 10), ylim=(-3, 3),
                                   cmap2='Reds', savepath=None,
                                   aux_var=None):
    """Contours of the target's density and of q's on a 100 x 100 grid
    (viabel_tpu/experiments.py:217-243); `aux_var`, when given, is
    appended to the variational parameter.  The densities are evaluated
    in torch on the parameter's device and dtype, the grid's values then
    brought to numpy for matplotlib."""
    var_param = torch.as_tensor(var_param)
    if aux_var is not None:
        var_param = torch.cat([var_param, torch.atleast_1d(torch.as_tensor(
            aux_var, dtype=var_param.dtype, device=var_param.device))])
    import matplotlib.pyplot as plt
    xlist = np.linspace(*xlim, 100)
    ylist = np.linspace(*ylim, 100)
    X, Y = np.meshgrid(xlist, ylist)
    XY = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], axis=1),
                         dtype=var_param.dtype, device=var_param.device)
    with torch.no_grad():
        Z = _host(torch.exp(log_density(XY))).reshape(X.shape)
        Zapprox = _host(torch.exp(var_family.log_prob(var_param, XY))
                        ).reshape(X.shape)
    plt.contour(X, Y, Z, cmap='Greys', linestyles='solid')
    plt.contour(X, Y, Zapprox, cmap=cmap2, linestyles='solid')
    if savepath is not None:
        plt.savefig(savepath, bbox_inches='tight')
    plt.show()


def plot_history(history, B=None, ylabel=None):
    """A moving average of an optimization trace, log-scaled when the
    smoothed trace is positive throughout (viabel_tpu/experiments.py:
    246-265).  `B` is the averaging window; default a tenth of the trace,
    at most 500."""
    import matplotlib.pyplot as plt
    history = _host(history).astype(float)
    B = max(1, min(500, history.size // 10) if B is None else B)
    csum = np.concatenate([[0.0], np.cumsum(history)])
    smoothed = (csum[B:] - csum[:-B]) / B
    _, ax = plt.subplots()
    ax.plot(smoothed)
    if np.all(smoothed > 0):
        ax.set_yscale('log')
    ax.set_xlabel('iteration')
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    plt.show()


def plot_dist_to_opt_param(var_param_history, opt_param):
    """The Euclidean distance of each iterate to the final parameter
    (viabel_tpu/experiments.py:268-278)."""
    import matplotlib.pyplot as plt
    gap = _host(var_param_history) - _host(opt_param)
    _, ax = plt.subplots()
    ax.plot(np.sqrt(np.sum(gap * gap, axis=1)))
    ax.set_title('convergence toward the final parameter')
    ax.set_xlabel('iteration')
    ax.set_ylabel('distance to optimum')
    plt.show()


def _stage_banner(name):
    """Section header of the experiment's console log
    (viabel_tpu/experiments.py:283-287)."""
    print()
    print('======== {} ========'.format(name), flush=True)


def _wall(fn, device):
    """``(seconds, fn())`` on the host clock, closed by a synchronize of
    `device` when it is a card."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def _split(generator, k):
    """`k` generators on `generator`'s device, seeded by `k` 64-bit seeds
    drawn from it in turn: the counterpart of ``jax.random.split``."""
    return [torch.Generator(device=generator.device).manual_seed(
        philox_seed(generator)) for _ in range(k)]


def _samples_and_log_weights(log_density, var_family, var_param, n_samples,
                             source):
    """`get_samples_and_log_weights` from a generator, or the same pass on
    given base draws z (the seam the parity tests feed)."""
    if isinstance(source, torch.Generator):
        return get_samples_and_log_weights(log_density, var_family,
                                           var_param, n_samples, source,
                                           var_param.device)
    samples, lw, _ = draw_and_score(log_density, var_family, var_param,
                                    source)
    return samples, lw


def _optimize_and_check_results(log_density, var_family, objective_and_grad,
                                init_var_param, true_mean, true_cov,
                                streams, plot_contours=False, ylabel=None,
                                contour_kws=None, elbo=None, n_iters=5000,
                                bound_w2=True, verbose=False, use_psis=True,
                                n_psis_samples=1000000, **kwargs):
    """One stage of `run_experiment`: adagrad, the accuracy check, the
    bound pass and PSIS (viabel_tpu/experiments.py:290-345); with
    `plot_contours` the objective's history (labelled `ylabel`) and the
    distance to the fit after the fit, and the contours after the bound
    pass.

    `streams` is ``(optimizer, bound pass, PSIS)``: each a generator, or
    the draws themselves (the optimizer's ``(n_iters, n_mc, d)`` block, the
    passes' base draws z).  `kwargs` go to `adagrad_optimize`, with
    ``has_log_norm=False`` unless given, as in the JAX package.  Besides
    the JAX package's entries, the second result holds ``seconds``: the
    wall time of the optimizer, the bound pass and PSIS.
    """
    opt_src, bound_src, psis_src = streams
    device = init_var_param.device
    kwargs.setdefault('has_log_norm', False)
    kwargs['generator' if isinstance(opt_src, torch.Generator)
           else 'draws'] = opt_src
    seconds = {}
    seconds['optimize'], (opt_param, var_param_history, value_history,
                          _) = _wall(lambda: adagrad_optimize(
                              n_iters, objective_and_grad, init_var_param,
                              device=device, **kwargs), device)
    if plot_contours:
        plot_history(value_history, ylabel=ylabel)
        plot_dist_to_opt_param(var_param_history, opt_param)
    accuracy_results = check_approx_accuracy(var_family, opt_param,
                                             true_mean, true_cov, verbose)
    other_results = dict(opt_param=_host(opt_param),
                         var_param_history=_host(var_param_history),
                         value_history=_host(value_history),
                         seconds=seconds)
    if bound_w2 not in [False, None]:
        n_samples = 1000000 if bound_w2 is True else int(bound_w2)
        print()

        def bound_pass():
            samples, log_weights = _samples_and_log_weights(
                log_density, var_family, opt_param, n_samples, bound_src)
            var_dist_cov = _host(var_family.mean_and_cov(opt_param)[1])
            # None for df <= 4 t families: empirical fallback from samples
            moment_bound_fn = family_moment_bounds(var_family, opt_param)
            return all_bounds(
                log_weights,
                samples=samples if moment_bound_fn is None else None,
                q_var=var_dist_cov, moment_bound_fn=moment_bound_fn,
                log_norm_bound=elbo)

        seconds['bounds'], bounds = _wall(bound_pass, device)
        other_results.update(bounds)
        print('bound estimation (CUBO + ELBO, {:,} MC samples) took {} to '
              'run'.format(n_samples, format_seconds(seconds['bounds'])))
        if verbose:
            print()
            print_bounds(other_results)
    if plot_contours:
        plot_approx_and_exact_contours(log_density, var_family, opt_param,
                                       **(contour_kws or {}))
    if use_psis:
        _stage_banner('PSIS-corrected moments')

        def psis_pass():
            samples, lw = _samples_and_log_weights(
                log_density, var_family, opt_param, n_psis_samples, psis_src)
            slw, khat = psislw(lw)
            return _psis_results(samples.T, slw, khat, true_mean, true_cov,
                                 None, verbose)[0]

        seconds['psis'], other_results['psis_results'] = _wall(psis_pass,
                                                               device)
    return accuracy_results, other_results


def _run_stages(log_density, var_family, klvi, chivi, init_param, true_mean,
                true_cov, kl_streams, chivi_streams, plot_contours=False,
                **kwargs):
    """KLVI's stage, then CHIVI's with KLVI's ``log_norm_bound`` as its
    ELBO (viabel_tpu/experiments.py:374-387), each on its streams."""
    _stage_banner('KLVI')
    kl_results, other_kl_results = _optimize_and_check_results(
        log_density, var_family, klvi, init_param, true_mean, true_cov,
        kl_streams, plot_contours, '-ELBO', **kwargs)
    kl_results['method'] = 'KLVI'
    _stage_banner('CHIVI')
    elbo = other_kl_results.get('log_norm_bound')
    chivi_results, other_chivi_results = _optimize_and_check_results(
        log_density, var_family, chivi, init_param, true_mean, true_cov,
        chivi_streams, plot_contours, 'CUBO', elbo=elbo, **kwargs)
    chivi_results['method'] = 'CHIVI'
    return (klvi, chivi, kl_results, chivi_results, other_kl_results,
            other_chivi_results)


def run_experiment(log_density, var_family, init_param, true_mean, true_cov,
                   kl_n_samples=100, chivi_n_samples=500, alpha=2,
                   plot_contours=None, generator=None, presampled=True,
                   device=None, **kwargs):
    """KLVI then CHIVI on a target, CHIVI reusing KLVI's ELBO as its
    log-normalizer bound; each fit is followed by a bound pass of
    `bound_w2` samples and PSIS at `n_psis_samples`
    (viabel_tpu/experiments.py:348-387).

    `log_density` is a `models.Model` (whose `kernel` tag routes the bound
    and PSIS passes to the fused kernels) or a batched callable.  Runs on
    `device` (None: the CUDA card).  `generator` (default: seed 0 there)
    is split into KLVI's and CHIVI's generators, and each of those into
    the optimizer's, the bound pass's and PSIS's, six streams in all.
    `kwargs` go to each stage (`n_iters`, `bound_w2`, `n_psis_samples`,
    `use_psis`, `verbose`, `contour_kws`) and on to `adagrad_optimize`
    (the learning rates, `window`, ``has_log_norm``, False by default).

    With `plot_contours` the contours of the target and of q are drawn at
    the init and after each bound pass, and each fit's objective history
    and distance to its final parameter after the fit
    (viabel_tpu/experiments.py:305-309, 333-335, 364-371); ``None`` draws
    them for a 2-D target when matplotlib imports.

    Returns ``(klvi, chivi, kl_results, chivi_results, other_kl_results,
    other_chivi_results)`` as the JAX package does, the arrays in numpy.
    """
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    klvi = black_box_klvi(var_family, log_density, kl_n_samples,
                          presampled=presampled)
    chivi = black_box_chivi(alpha, var_family, log_density, chivi_n_samples,
                            presampled=presampled)
    init_param = torch.as_tensor(init_param, device=device)
    true_mean = np.asarray(true_mean)
    if plot_contours is None:
        try:
            import matplotlib  # noqa: F401
            plot_contours = true_mean.size == 2
        except ImportError:
            plot_contours = False
    if plot_contours:
        plot_approx_and_exact_contours(log_density, var_family, init_param,
                                       **kwargs.get('contour_kws', {}))
    kl_gen, chivi_gen = _split(generator, 2)
    return _run_stages(log_density, var_family, klvi, chivi, init_param,
                       true_mean, true_cov, _split(kl_gen, 3),
                       _split(chivi_gen, 3), plot_contours=plot_contours,
                       **kwargs)
