"""Pareto-smoothed importance sampling over a sharded log-weight array.

PyTorch port of viabel_tpu/parallel/sharded_psis.py.  Only the largest
``tail_len = ceil(min(0.2 n, 3 sqrt(n / Reff)))`` weights (with n the
global count) enter the GPD fit, so:

1. each shard takes its local top ``tail_len + 1`` (`torch.topk`), after
   the global maximum is subtracted;
2. only those ``n_shards x (tail_len + 1)`` candidates are gathered, in
   shard order;
3. the global tail, cutoff, GPD fit (`psis.gpdfit`) and smoothed quantiles
   are computed once, from the gathered candidates;
4. each shard rewrites its own above-cutoff weights with the quantile of
   their rank in the global tail (a `torch.searchsorted`), so body weights
   never move;
5. renormalization is a maximum and a sum of exponentials over shards.

Ties in the tail take the JAX package's sharded convention (its module
docstring, tests/test_parallel.py:466): ranks come from the values alone,
so exactly equal tail values receive the same smoothed quantile, where the
unsharded `psis.psislw` gives each its own (in top-k order).

Shards run on their entries' devices, the ones another rank holds on that
rank, and the cross-shard steps go through `distributed.exchange`; every
rank reaches the same khat and renormalizer.
"""

import numpy as np
import torch

from .._device import on_device
from ..bounds import _as_tensor
from ..psis import _K_MIN, _tail_len, gpdfit, gpinv
from .distributed import exchange, rank
from .mesh import Sharded, fetch_global, shard_over

__all__ = ['psislw_sharded', 'psisloo_sharded', 'sharded_psis_moments']


def _held(line):
    """The shard indices of `line` this rank holds."""
    return [i for i, e in enumerate(line) if e.rank == rank()]


def _owners(line):
    return [e.rank for e in line]


def _sum_in_order(tensors):
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t
    return out


def _column_max(parts, line, m, dtype, home):
    """The per-column maximum over every shard of `parts` ({i: (n_i, m)})
    as an (m,) tensor on `home`."""
    maxima = exchange({i: torch.max(parts[i], dim=0).values
                       for i in _held(line)}, _owners(line), (m,), dtype,
                      home)
    return torch.max(torch.stack(maxima), dim=0).values


def _log_normalizer(parts, line, m, dtype, home):
    """``log sum exp`` of each column over every shard: the maximum, then
    each shard's sum of exponentials below it, summed in shard order."""
    big = _column_max(parts, line, m, dtype, home)
    sums = exchange({i: torch.sum(torch.exp(parts[i] - big.to(
        parts[i].device)), dim=0) for i in _held(line)}, _owners(line),
        (m,), dtype, home)
    return torch.log(_sum_in_order(sums)) + big


def _smooth(parts, line, n_total, m, tail_len, cutoffmin, dtype, home):
    """PSIS of the columns of a sharded ``(n_total, m)`` log-weight array:
    `parts` maps each held shard i of `line` to its ``(n_total / S, m)``
    block.  Returns the smoothed blocks and the (m,) khats on `home`
    (viabel_tpu/parallel/sharded_psis.py:35-98)."""
    n_local = n_total // len(line)
    gmax = _column_max(parts, line, m, dtype, home)
    x = {i: parts[i] - gmax.to(parts[i].device) for i in parts}

    # (1)-(2): each shard's top tail_len + 1 (the global top tail_len + 1
    # are among them), gathered
    k_local = min(tail_len + 1, n_local)
    tops = {i: torch.topk(x[i], k_local, dim=0) for i in x}
    cands = exchange({i: tops[i].values for i in tops}, _owners(line),
                     (k_local, m), dtype, home)
    g_top = torch.topk(torch.cat(cands), tail_len + 1, dim=0).values

    # (3): the global tail, cutoff and fit, once a column
    khats, smooth, tails, quantiles, cutoffs = [], [], [], [], []
    ar = torch.arange(tail_len, device=home)
    for j in range(m):
        xcutoff = torch.clamp(g_top[tail_len, j], min=cutoffmin)
        tail_asc = torch.flip(g_top[:tail_len, j], (0,))
        mask = tail_asc > xcutoff
        n2 = torch.sum(mask)
        expxcutoff = torch.exp(xcutoff)
        k, sigma = gpdfit(torch.exp(tail_asc) - expxcutoff, mask, n2)
        khats.append(torch.where(n2 <= 4, torch.full_like(k, float('inf')),
                                 k))
        smooth.append((n2 > 4) & (k >= _K_MIN) & torch.isfinite(k))
        pos = (ar - (tail_len - n2)).to(dtype)
        sti = torch.clamp((pos + 0.5) / torch.clamp(n2, min=1).to(dtype),
                          1e-12, 1 - 1e-12)
        quantiles.append(torch.log(gpinv(sti, k, sigma) + expxcutoff))
        tails.append(tail_asc)
        cutoffs.append(xcutoff)

    # (4): each shard rewrites its own candidates above the cutoff
    out = {}
    for i in x:
        dev = x[i].device
        vals, idx = tops[i]
        new = x[i].clone()
        with on_device(dev):
            for j in range(m):
                tail, cut = tails[j].to(dev), cutoffs[j].to(dev)
                do = smooth[j].to(dev)
                rank_j = torch.clamp(torch.searchsorted(
                    tail, vals[:, j].contiguous()), 0, tail_len - 1)
                col = torch.where((vals[:, j] > cut) & do,
                                  quantiles[j].to(dev)[rank_j], vals[:, j])
                new[:, j] = new[:, j].scatter(0, idx[:, j], col)
                new[:, j] = torch.where(do, torch.clamp(new[:, j], max=0.0),
                                        new[:, j])
        out[i] = new

    # (5): renormalize over every shard
    norm = _log_normalizer(out, line, m, dtype, home)
    out = {i: out[i] - norm.to(out[i].device) for i in out}
    return out, torch.stack(khats)


def _line_parts(x, mesh, axis):
    """``(line, {shard: block}, shape, dtype)`` of `x`, a `Sharded` split
    over `axis` at dim 0 (and nowhere else) or an array or tensor, split
    here (a 0-d one gives no blocks)."""
    if not isinstance(x, Sharded):
        x = _as_tensor(x)
        if x.dim() == 0:
            return mesh.line(axis), {}, (), x.dtype
        x = shard_over(x, mesh, axis)
    if x.mesh is not mesh or x.spec[0] != axis or any(
            a is not None for a in x.spec[1:]):
        raise ValueError('the array must be split over the mesh axis {!r} '
                         'at dim 0, got spec {}'.format(axis, x.spec))
    return (mesh.line(axis), {c[0]: t for c, t in x.blocks.items()},
            x.shape, x.dtype)


def psislw_sharded(log_weights, mesh, Reff=1.0, axis='sample'):
    """PSIS over a log-weight array split over the mesh's `axis`
    (viabel_tpu/parallel/sharded_psis.py:134-154).

    `log_weights` is a `Sharded` split at dim 0 (see `shard_over`) or a
    tensor or array, which is split here.  1-D input: returns
    ``(smoothed_log_weights, khat)`` with khat 0-d; 2-D input (draws x
    columns): each column is smoothed on its own and khat is ``(m,)``.
    The smoothed weights are a `Sharded` placed as the input; khat is on
    this rank's home device of the mesh."""
    line, parts, shape, dtype = _line_parts(log_weights, mesh, axis)
    if len(shape) not in (1, 2):
        raise ValueError('Argument `lw` must be 1 or 2 dimensional.')
    n = shape[0]
    if n <= 1:
        raise ValueError('More than one log-weight needed.')
    tail_len = _tail_len(n, Reff)
    cutoffmin = float(np.log(torch.finfo(dtype).tiny))
    cols = {i: (p[:, None] if p.dim() == 1 else p) for i, p in parts.items()}
    m = 1 if len(shape) == 1 else shape[1]
    out, khat = _smooth(cols, line, n, m, tail_len, cutoffmin, dtype,
                        mesh.home())
    if len(shape) == 1:
        out = {i: p[:, 0] for i, p in out.items()}
        khat = khat[0]
    return (Sharded(mesh, (axis,), shape, dtype,
                    {(i,): p for i, p in out.items()}), khat)


def psisloo_sharded(log_lik, mesh, axis='sample', **kwargs):
    """PSIS leave-one-out log predictive densities over a ``(n_draws,
    n_points)`` log-likelihood matrix split over the mesh's `axis`
    (viabel_tpu/parallel/sharded_psis.py:169-190).  Returns ``(loo, loos,
    ks)``: the float total and the numpy ``(n_points,)`` terms and
    khats."""
    line, parts, shape, dtype = _line_parts(log_lik, mesh, axis)
    if len(shape) != 2:
        raise ValueError('log_lik must be (n_draws, n_points), got shape {}'
                         .format(shape))
    neg = Sharded(mesh, (axis,), shape, dtype,
                  {(i,): -p for i, p in parts.items()})
    lw, ks = psislw_sharded(neg, mesh, axis=axis, **kwargs)
    terms = {c[0]: lw.blocks[c] + parts[c[0]] for c in lw.blocks}
    loos = _log_normalizer(terms, line, shape[1], dtype, mesh.home())
    loos = fetch_global(loos)
    return float(np.sum(loos)), loos, fetch_global(ks)


def _psis_moments(x, slw, line, d, dtype, home):
    """Self-normalized importance-weighted mean and covariance of the
    sharded samples `x` ({i: (n_i, d)}) under the smoothed log-weights
    `slw` ({i: (n_i,)}) (viabel_tpu/parallel/sharded_psis.py:193-204)."""
    owners, held = _owners(line), _held(line)
    top = exchange({i: torch.max(slw[i]) for i in held}, owners, (), dtype,
                   home)
    big = torch.max(torch.stack(top))
    w = {i: torch.exp(slw[i] - big.to(slw[i].device)) for i in held}
    total = _sum_in_order(exchange({i: torch.sum(w[i]) for i in held},
                                   owners, (), dtype, home))
    w = {i: w[i] / total.to(w[i].device) for i in held}
    mean = _sum_in_order(exchange(
        {i: torch.sum(w[i][:, None] * x[i], dim=0) for i in held}, owners,
        (d,), dtype, home))
    centred = {i: x[i] - mean.to(x[i].device) for i in held}
    cov = _sum_in_order(exchange(
        {i: (w[i][:, None] * centred[i]).T @ centred[i] for i in held},
        owners, (d, d), dtype, home))
    return mean, cov


def sharded_psis_moments(samples, smoothed_log_weights, mesh,
                         axis='sample'):
    """The PSIS-weighted mean and covariance of samples split over the
    mesh's `axis` under their smoothed log-weights
    (viabel_tpu/parallel/sharded_psis.py:219-228).  Returns ``(mean,
    cov)`` tensors on this rank's home device of the mesh."""
    line, x, shape, dtype = _line_parts(samples, mesh, axis)
    _, slw, _, _ = _line_parts(smoothed_log_weights, mesh, axis)
    return _psis_moments(x, slw, line, shape[1], dtype, mesh.home())
