"""Bound passes split over the sample axis of a mesh.

PyTorch port of viabel_tpu/parallel/sharded_bounds.py.  Each shard draws
and scores its ``n / S`` samples on its own device with the bound pass's
kernels (`experiments.draw_and_score`: K1 for a kernel-tagged model under a
mean-field family, else the log-weights scored in torch and K3; K2 for a
mean-field Gaussian q of a kernel-tagged model), and the combine reduces
the shard's partials rows to its statistics, which become one Chan row
``[count, max, mean_e, M2_e, mean_lw, M2_lw]``.  The shards' rows are then
merged by the combine again, in shard order (never in order of
completion), so a run over two ranks equals the one-process mesh of the
same shards bit for bit.  Samples and log-weights stay on their devices;
only rows, moment sums and PSIS tail candidates cross devices and ranks
(`distributed.exchange`).

Draws: for K2 (and `philox_normal`, which writes the same z), shard i
scores rows ``[i n / S, (i + 1) n / S)`` of the stream of the pass's seed,
so the sharded pass scores exactly the unsharded pass's draws
(`experiments.get_samples_and_log_weights` of that seed).  Any other q's
shard i draws ``var_family.base_sample`` from a generator on its device
seeded with ``ops.philox.fold_in(seed, i)``, the counterpart of the JAX
package's ``fold_in(key, idx)``.  A shard's kernel that fails to build or
launch fails the pass: nothing falls back to a plain version on a card.
"""
import math

import numpy as np
import torch

from .._device import on_device
from ..bounds import (STAT_KEYS, _as_tensor, divergence_bound, error_bounds,
                      wasserstein_bounds)
from ..experiments import _draws_in_kernel, draw_and_score
from ..objectives import map_draws
from ..ops import gaussian_lw as _gaussian_ops
from ..ops import lw_stats as _lw_ops
from ..ops.philox import fold_in, philox_seed
from ..psis import _tail_len
from .distributed import exchange
from .mesh import Sharded
from .sharded_psis import (_held, _line_parts, _owners, _psis_moments,
                           _smooth, _sum_in_order)

__all__ = [
    'sharded_log_weight_stats',
    'sharded_sample_stats',
    'sharded_all_bounds',
    'sharded_bound_psis',
]


def _stats_row(stats, n):
    """A shard's (5,) statistics as one Chan row of the combine's partials
    layout: ``[count, max, mean_e, M2_e, mean_lw, M2_lw]``, M2 = n std^2.

    A shard whose log-weights are all -inf has NaN e-moments of its own
    (``exp(-inf - -inf)``); against any finite pooled max its weights are
    0, so its row takes ``mean_e = M2_e = 0``, the rule of a chunk of -inf
    alone (`ops.lw_stats._rows_partials`).  Its lw moments stay -inf and
    NaN, and against a pooled max of -inf the combine's rescale still
    gives NaN, as the JAX package does."""
    nt = torch.full((), float(n), dtype=stats.dtype, device=stats.device)
    empty = stats[0] == -math.inf
    zero = torch.zeros_like(stats[1])
    return torch.stack([nt, stats[0], torch.where(empty, zero, stats[1]),
                        torch.where(empty, zero, stats[2] * stats[2] * nt),
                        stats[3], stats[4] * stats[4] * nt])


def _merge_stats(rows, line, dtype, home, alpha):
    """The (5,) statistics of every shard's samples: the held shards' rows
    (`_stats_row`) gathered in shard order and merged by the combine."""
    got = exchange(rows, _owners(line), (6,), dtype, home)
    return _lw_ops.combine_partials(torch.stack(got).contiguous(), alpha)


def _host_stats(stats, n):
    out = dict(zip(STAT_KEYS, stats.cpu().tolist()))
    out['n'] = n
    return out


def _moments(samples, line, n, d, dtype, home, with_cov):
    """Centred moments C2, C4 (and the covariance with `with_cov`) of the
    sharded samples ({i: (n / S, d)}), the global mean first, then the
    centred sums, each summed in shard order
    (viabel_tpu/parallel/sharded_bounds.py:55-72)."""
    owners, held = _owners(line), _held(line)
    mean = _sum_in_order(exchange({i: torch.sum(samples[i], dim=0)
                                   for i in held}, owners, (d,), dtype,
                                  home)) / n
    centred = {i: samples[i] - mean.to(samples[i].device) for i in held}
    norms = {i: torch.sum(c ** 2, dim=1) for i, c in centred.items()}
    c24 = _sum_in_order(exchange(
        {i: torch.stack([torch.sum(v), torch.sum(v ** 2)])
         for i, v in norms.items()}, owners, (2,), dtype, home)) / n
    out = dict(C2=c24[0], C4=c24[1])
    if with_cov:
        out['cov'] = _sum_in_order(exchange(
            {i: c.T @ c for i, c in centred.items()}, owners, (d, d), dtype,
            home)) / (n - 1)
    return out


def sharded_log_weight_stats(log_weights, mesh, alpha=2.0, axis='sample'):
    """`bounds.log_weight_stats` of log-weights split over the mesh's
    `axis` (a `Sharded` split at dim 0, or a tensor or array split here),
    a multi-dimensional input pooled as one flat vector
    (viabel_tpu/parallel/sharded_bounds.py:96-113): each shard's K3 and
    combine, then the rows merged.  Returns the floats and ``n``."""
    line, parts, shape, dtype = _line_parts(log_weights, mesh, axis)
    n = int(np.prod(shape))
    rows = {}
    for i, lw in parts.items():
        with on_device(lw.device):
            flat = lw.reshape(-1).contiguous()
            rows[i] = _stats_row(_lw_ops.lw_stats(flat, float(alpha)),
                                 flat.shape[0])
    stats = _merge_stats(rows, line, dtype, mesh.home(), float(alpha))
    return _host_stats(stats, n)


def sharded_sample_stats(samples, mesh, axis='sample'):
    """Centred moments C2, C4 and the covariance of samples split over the
    mesh's `axis` (viabel_tpu/parallel/sharded_bounds.py:126-132), as
    tensors on this rank's home device of the mesh."""
    line, parts, shape, dtype = _line_parts(samples, mesh, axis)
    return _moments(parts, line, shape[0], shape[1], dtype, mesh.home(),
                    True)


def _pass_seed(seed):
    """A pass's 64-bit seed: an int as it is, or one drawn from a
    generator."""
    if isinstance(seed, torch.Generator):
        return philox_seed(seed)
    return int(seed)


def _draw_shards(log_density, family, var_param, n, source, line, alpha,
                 need_samples):
    """Each held shard's ``(samples or None, lw, statistics row)``.
    `source` is the pass's seed (an int) or the ``(n, ...)`` base draws
    (a dict of blocks for dict draws), of which shard i takes its rows."""
    n_local = n // len(line)
    d = family.dim
    out = {}
    for i in _held(line):
        device = line[i].device
        start = i * n_local
        with on_device(device):
            vp = var_param.to(device)
            if isinstance(source, int) and _draws_in_kernel(log_density,
                                                            family):
                lw, partials = _gaussian_ops.gaussian_sample_score_partials(
                    vp[:d].contiguous(), vp[d:].contiguous(), n_local,
                    source, 0, log_density.kernel,
                    log_density.kernel_data_like(vp), alpha, start)
                stats = _lw_ops.combine_partials(partials, alpha)
                samples = None
                if need_samples:
                    samples = family.transform(vp, _gaussian_ops.philox_normal(
                        n_local, d, source, 0, start, vp.dtype, device))
            else:
                if isinstance(source, int):
                    generator = torch.Generator(device=device).manual_seed(
                        fold_in(source, i))
                    z = family.base_sample(generator, n_local, vp.dtype)
                else:
                    z = map_draws(lambda v: v[start:start + n_local].to(
                        device), source)
                samples, lw, stats = draw_and_score(log_density, family, vp,
                                                    z, alpha)
            out[i] = (samples, lw, _stats_row(stats, n_local).to(
                var_param.dtype))
    return out


def _pass(log_density, family, var_param, n, source, line, alpha, home,
          moments=False, with_cov=False, psis=False, psis_moments=False,
          need_samples=False, reff=1.0):
    """One sharded bound pass over `line`: the merged (5,) statistics,
    with `moments` the empirical C2/C4 (and the covariance with
    `with_cov`), with `psis` the smoothed log-weights and khat (tail length
    from `reff`; with `psis_moments` also the PSIS-weighted mean and
    covariance).  Returns a dict
    of the held shards' ``samples``, ``lw`` and ``slw`` (dicts by shard)
    and the reduced tensors on `home`."""
    dtype = var_param.dtype
    d = family.dim
    shards = _draw_shards(log_density, family, var_param, n, source, line,
                          alpha, need_samples or moments or psis_moments)
    out = dict(samples={i: s[0] for i, s in shards.items()},
               lw={i: s[1] for i, s in shards.items()})
    out['stats'] = _merge_stats({i: s[2] for i, s in shards.items()}, line,
                                dtype, home, alpha)
    if moments:
        out.update(_moments(out['samples'], line, n, d, dtype, home,
                            with_cov))
    if psis:
        cutoffmin = float(np.log(torch.finfo(dtype).tiny))
        slw, khat = _smooth({i: lw[:, None] for i, lw in out['lw'].items()},
                            line, n, 1, _tail_len(n, reff), cutoffmin, dtype,
                            home)
        out['slw'] = {i: v[:, 0] for i, v in slw.items()}
        out['khat'] = khat[0]
        if psis_moments:
            out['psis_mean'], out['psis_cov'] = _psis_moments(
                out['samples'], out['slw'], line, d, dtype, home)
    return out


_ALPHA_HINT = {'sharded_all_bounds': '; use sharded_log_weight_stats with '
               'divergence_bound for other alpha values',
               'sharded_bound_psis': ''}


def _check_pass(name, mesh, axis, n_samples, alpha):
    """The JAX package's checks of a sharded pass
    (viabel_tpu/parallel/sharded_bounds.py:204-217, 335-344)."""
    if alpha != 2:
        raise ValueError('{} requires alpha == 2 (the Wasserstein and '
                         'moment-error bounds are only valid for the '
                         '2-divergence){}'.format(name, _ALPHA_HINT[name]))
    if axis not in mesh.axis_names:
        raise ValueError('the bound pass shards over a mesh axis named {!r};'
                         ' the given mesh has axes {}'.format(
                             axis, mesh.axis_names))
    if n_samples % mesh.shape[axis]:
        raise ValueError('the mesh axis size ({}) must divide n_samples '
                         '({})'.format(mesh.shape[axis], n_samples))


def _host_bound_assembly(stats, alpha, log_norm_bound, moment_bound_fn,
                         compute_moments, with_cov, q_var, p_var):
    """The bound algebra on the merged statistics, as
    viabel_tpu/parallel/sharded_bounds.py:247-273."""
    d2, log_norm_bound = divergence_bound(
        None, alpha=alpha, log_norm_bound=log_norm_bound,
        return_log_norm_bound=True, _stats=stats)
    moments = None
    if compute_moments:
        moments = dict(C2=stats['C2'], C4=stats['C4'])
        if with_cov:
            moments['cov'] = stats['cov']
    results = wasserstein_bounds(d2, samples=None,
                                 moment_bound_fn=moment_bound_fn,
                                 _moments=moments)
    if q_var is None and moments is not None and with_cov:
        q_var = moments['cov'].cpu().numpy()
        if q_var.shape == (1, 1):
            q_var = q_var[0, 0]
    results.update(error_bounds(W1=results['W1'], W2=results['W2'],
                                q_var=np.inf if q_var is None else q_var,
                                p_var=np.inf if p_var is None else p_var))
    results['d2'] = d2
    results['log_norm_bound'] = log_norm_bound
    return results


def _sharded_pass(name, model_log_prob, family, var_param, n_samples, seed,
                  mesh, alpha, axis, moment_bound_fn, q_var, psis=False,
                  need_samples=False, reff=1.0):
    """The checks, the pass over the mesh's `axis` and its host statistics
    dict, shared by `sharded_all_bounds` and `sharded_bound_psis`."""
    _check_pass(name, mesh, axis, n_samples, alpha)
    var_param = _as_tensor(var_param)
    compute_moments = moment_bound_fn is None
    with_cov = compute_moments and q_var is None
    out = _pass(model_log_prob, family, var_param, n_samples,
                _pass_seed(seed), mesh.line(axis), float(alpha), mesh.home(),
                moments=compute_moments, with_cov=with_cov, psis=psis,
                need_samples=need_samples, reff=reff)
    stats = _host_stats(out['stats'], n_samples)
    if compute_moments:
        stats['C2'], stats['C4'] = float(out['C2']), float(out['C4'])
        if with_cov:
            stats['cov'] = out['cov']
    return out, stats, compute_moments, with_cov


def _placed(mesh, axis, shape, dtype, parts):
    return Sharded(mesh, (axis,), shape, dtype,
                   {(i,): p for i, p in parts.items()})


def sharded_all_bounds(model_log_prob, family, var_param, n_samples, seed,
                       mesh, alpha=2.0, axis='sample', log_norm_bound=None,
                       moment_bound_fn=None, q_var=None, p_var=None,
                       return_log_weights=False, return_samples=False):
    """The bound pass split over the mesh's `axis`: each shard draws,
    scores and reduces ``n_samples / S`` samples on its device, and the
    statistics are merged (viabel_tpu/parallel/sharded_bounds.py:189-245).

    `seed` is the pass's 64-bit seed (an int, or a `torch.Generator` a seed
    is drawn from; every rank must pass the same).  Returns the
    `all_bounds` results dict; with `return_log_weights` (and
    `return_samples`) also the log-weights (and samples) as `Sharded`
    arrays split over `axis`."""
    out, stats, compute_moments, with_cov = _sharded_pass(
        'sharded_all_bounds', model_log_prob, family, var_param, n_samples,
        seed, mesh, alpha, axis, moment_bound_fn, q_var,
        need_samples=return_samples)
    results = _host_bound_assembly(stats, alpha, log_norm_bound,
                                   moment_bound_fn, compute_moments,
                                   with_cov, q_var, p_var)
    dtype = _as_tensor(var_param).dtype
    extras = []
    if return_log_weights:
        extras.append(_placed(mesh, axis, (n_samples,), dtype, out['lw']))
    if return_samples:
        extras.append(_placed(mesh, axis, (n_samples, family.dim), dtype,
                              out['samples']))
    if extras:
        return (results, *extras)
    return results


def sharded_bound_psis(model_log_prob, family, var_param, n_samples, seed,
                       mesh, alpha=2.0, axis='sample', Reff=1.0,
                       log_norm_bound=None, moment_bound_fn=None,
                       q_var=None, p_var=None):
    """`sharded_all_bounds` and `parallel.psislw_sharded` in one pass, the
    log-weights never leaving their shards
    (viabel_tpu/parallel/sharded_bounds.py:314-380).  Returns ``(results,
    smoothed_log_weights, khat)``: the `all_bounds` dict, the smoothed
    log-weights as a `Sharded` split over `axis`, and khat as a float."""
    if n_samples <= 1:
        raise ValueError('More than one log-weight needed.')
    out, stats, compute_moments, with_cov = _sharded_pass(
        'sharded_bound_psis', model_log_prob, family, var_param, n_samples,
        seed, mesh, alpha, axis, moment_bound_fn, q_var, psis=True,
        reff=Reff)
    results = _host_bound_assembly(stats, alpha, log_norm_bound,
                                   moment_bound_fn, compute_moments,
                                   with_cov, q_var, p_var)
    slw = _placed(mesh, axis, (n_samples,), _as_tensor(var_param).dtype,
                  out['slw'])
    return results, slw, float(out['khat'])
