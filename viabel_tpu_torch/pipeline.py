"""Validated VI end to end: optimize -> bound pass -> PSIS.

PyTorch port of viabel_tpu/pipeline.py: the single run `validated_vi`, and
the batches of runs `validated_vi_multistart` (K starts) and
`validated_vi_sweep` (K learning rates).  The JAX package compiles the
whole workflow into one program (vmapped over the runs of a batch); here
it runs as the same sequence of steps on one device:

* windowed adagrad on presampled KLVI (`optimizers._adagrad_run`; a
  batch's K runs at once, `optimizers._adagrad_runs`);
* the bound pass: base draws z, then the fused kernel K1 (transform, score,
  per-chunk statistics) and the combine kernel where the model has a CUDA
  log density (`experiments.draw_and_score`);
* PSIS over the log-weights and the PSIS-corrected moments;
* the scalar bound algebra on the host, after one ``.cpu()`` of each
  reduced result.

A batch's bound passes, PSIS and moments run one run after another.

With ``mesh=`` (`parallel`): `validated_vi` runs the optimizer once, on the
mesh's first device, and splits the bound pass, PSIS and the corrected
moments over the mesh's ``sample`` axis (`parallel.sharded_bounds`); the
batches split their K runs over the ``chain`` axis, each device group
running its K / C runs as one batched optimizer on its first device, and
each run's bound pass over the group's ``sample`` axis when it has more
than one member.  The draws of a sharded bound pass come from a seed the
run's generator gives after its optimizer's draws (shard i from
``fold_in(seed, i)``), so its optimizer takes the unsharded run's draws.
"""
import warnings

import numpy as np
import torch

from ._device import default_generator, on_device, resolve_device
from ._trace import span, to_host
from .bounds import (STAT_KEYS, divergence_bound, error_bounds,
                     wasserstein_bounds)
from .experiments import draw_and_score
from .families import NoClosedFormMomentError
from .objectives import black_box_klvi, map_draws, stack_draws
from .ops.gaussian_lw import philox_normal
from .ops.philox import philox_seed
from .optimizers import (_adagrad_run, _adagrad_runs, _check_ran,
                         _learning_rates, _perturbed_inits, _wrap_objective)
from .parallel import distributed as _dist
from .parallel.mesh import Sharded
from .parallel.sharded_bounds import _pass
from .parallel.sharded_chains import chain_groups
from .psis import _psislw_1d, _tail_len, weighted_moments

__all__ = ['validated_vi', 'validated_vi_multistart', 'validated_vi_sweep',
           'DivergedRunWarning']


class DivergedRunWarning(UserWarning):
    """An optimizer run produced a non-finite fit: the pipeline returns
    infinite bounds and a NaN khat instead of raising, and warns with this
    category (viabel_tpu/pipeline.py:33-44)."""


def _optimize_and_average(obj, n_iters, window, learning_rate, epsilon,
                          learning_rate_end, init_param, opt_draws):
    """The adagrad run without its iterate history, returning the
    tail-quarter average (viabel_tpu/pipeline.py:61-78)."""
    values, log_norms, _, opt_param = _adagrad_run(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, opt_draws, keep_history=False)
    return values, log_norms, opt_param


def _closed_form_moments(var_family, opt_param, alpha):
    """Closed-form C2/C4 as a (2,) tensor, NaN placeholders for alpha != 2,
    or None when the family has no closed-form 4th moment
    (viabel_tpu/pipeline.py:81-99)."""
    if alpha != 2:
        return torch.full((2,), float('nan'), dtype=opt_param.dtype,
                          device=opt_param.device)
    try:
        return torch.stack([var_family.pth_moment(opt_param, 2),
                            var_family.pth_moment(opt_param, 4)])
    except NoClosedFormMomentError:
        return None


def _bound_and_psis(var_family, log_density, alpha, tail_len, opt_param,
                    bound_draws):
    """Draw -> score -> statistics -> PSIS at the fitted `opt_param`
    (viabel_tpu/pipeline.py:149-174)."""
    samples, lw, stats = draw_and_score(log_density, var_family, opt_param,
                                        bound_draws, alpha)
    moments = _closed_form_moments(var_family, opt_param, alpha)
    if moments is None:  # e.g. a t family with df <= 4: empirical C2/C4
        c = samples - torch.mean(samples, dim=0, keepdim=True)
        norm2 = torch.sum(c ** 2, dim=1)
        moments = torch.stack([torch.mean(norm2), torch.mean(norm2 ** 2)])
    slw, khat = _psislw_1d(lw, tail_len)
    psis_mean, psis_cov = weighted_moments(samples, slw)
    q_mean, q_cov = var_family.mean_and_cov(opt_param)
    return dict(opt_param=opt_param, q_mean=q_mean, q_cov=q_cov,
                log_weights=lw, smoothed_log_weights=slw, khat=khat,
                psis_mean=psis_mean, psis_cov=psis_cov, stats=stats,
                moments=moments)


def _pipeline_core(obj, var_family, log_density, n_iters, window,
                   learning_rate, epsilon, learning_rate_end, alpha,
                   tail_len, init_param, opt_draws, bound_draws):
    """Optimize -> draw -> score -> statistics -> PSIS
    (viabel_tpu/pipeline.py:138-174).

    `opt_draws` feeds the optimizer (the ``(n_iters, n_mc, d)`` block of a
    presampled objective, or a generator), and `bound_draws` holds the
    bound pass's base draws; the tests pass the exact draws the JAX
    package derives from its key split.  Every returned entry is a tensor
    on the input's device; ``stats`` is the (5,) `bounds.STAT_KEYS`
    tensor and ``moments`` the (2,) C2/C4 tensor.
    """
    values, log_norms, opt_param = _optimize_and_average(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, opt_draws)
    out = _bound_and_psis(var_family, log_density, alpha, tail_len,
                          opt_param, bound_draws)
    return dict(value_history=values, log_norm_history=log_norms, **out)


def _batch_core(objective_and_grad, has_log_norm, var_family, log_density,
                n_iters, window, lr_tables, epsilon, alpha, tail_len,
                init_params, opt_draws, bound_draws, mesh=None, axis='chain',
                sample_axis='sample'):
    """The pipeline of K runs (viabel_tpu/pipeline.py:393-412, 732-745):
    the K optimizer runs at once (`optimizers._adagrad_runs`), then each
    run's bound pass and PSIS in turn.

    `init_params` is ``(K, P)``, `lr_tables` the ``(K, n_iters)`` learning
    rates, `opt_draws` the ``(K, n_iters, n_mc, ...)`` draws of a
    presampled objective (or a list of K generators for any other) and
    `bound_draws` the ``(K, n, ...)`` base draws of the bound passes (dicts
    of such blocks for dict draws).  Returns `_pipeline_core`'s dict with a
    leading run axis on every entry.

    With `mesh`, the runs split over `axis` and, where the mesh has a
    `sample_axis` of more than one member, each run's bound pass over the
    group's members, shard i taking its rows of the run's bound draws
    (`_batch_mesh`); `tail_len` then follows from the draws.
    """
    if mesh is not None:
        K = init_params.shape[0]
        n = next(iter(bound_draws.values())).shape[1] if isinstance(
            bound_draws, dict) else bound_draws.shape[1]
        sharded = _check_run_axis(mesh, axis, sample_axis, K, n,
                                  'batch partitions runs',
                                  'the number of runs')
        presampled = getattr(objective_and_grad, 'presampled', False)

        def run_source(k, device):
            opt = (map_draws(lambda v: v[k].to(device), opt_draws)
                   if presampled else opt_draws[k])
            return opt, map_draws(lambda v: v[k].to(device), bound_draws)

        return _batch_mesh(
            objective_and_grad, has_log_norm, var_family, log_density,
            n_iters, window, lr_tables, epsilon, alpha, n, init_params,
            run_source, mesh, axis, sample_axis, sharded,
            (lambda k: map_draws(lambda v: v[k], bound_draws)) if sharded
            else None)
    values, log_norms, _, opt_params = _adagrad_runs(
        objective_and_grad, has_log_norm, n_iters, window, lr_tables,
        epsilon, init_params, opt_draws)
    runs = [_bound_and_psis(var_family, log_density, alpha, tail_len,
                            opt_params[k],
                            map_draws(lambda v: v[k], bound_draws))
            for k in range(init_params.shape[0])]
    out = {key: torch.stack([r[key] for r in runs]) for key in runs[0]}
    return dict(value_history=values, log_norm_history=log_norms, **out)


def _check_sample_axis(mesh, axis, n_bound_samples):
    """The JAX package's checks of `validated_vi(mesh=)`
    (viabel_tpu/pipeline.py:295-305)."""
    if axis not in mesh.axis_names:
        raise ValueError(
            'the bound pass shards over a mesh axis named {!r}; the '
            'given mesh has axes {} (build it with '
            "make_mesh(axis_names=('sample',)) or pass axis=)".format(
                axis, mesh.axis_names))
    if n_bound_samples % mesh.shape[axis]:
        raise ValueError('the mesh axis size ({}) must divide '
                         'n_bound_samples ({})'.format(
                             mesh.shape[axis], n_bound_samples))


def _check_run_axis(mesh, axis, sample_axis, n_runs, n_bound_samples,
                    what, count):
    """The JAX package's checks of the batches' `mesh=`
    (viabel_tpu/pipeline.py:604-632, 776-799); returns whether each run's
    bound pass splits over `sample_axis`."""
    if axis not in mesh.axis_names:
        raise ValueError(
            'the {} over a mesh axis named {!r}; the given mesh has axes {} '
            "(build it with make_mesh(axis_names=('chain', ...)) or pass "
            'axis=)'.format(what, axis, mesh.axis_names))
    if n_runs % mesh.shape[axis]:
        raise ValueError('the mesh axis size ({}) must divide {} ({})'
                         .format(mesh.shape[axis], count, n_runs))
    sharded = (sample_axis is not None and sample_axis != axis
               and sample_axis in mesh.axis_names
               and mesh.shape[sample_axis] > 1)
    if sharded and n_bound_samples % mesh.shape[sample_axis]:
        raise ValueError('the mesh {} axis size ({}) must divide '
                         'n_bound_samples ({})'.format(
                             sample_axis, mesh.shape[sample_axis],
                             n_bound_samples))
    return sharded


def _seeds_tensor(seeds, device):
    """64-bit seeds as int64 tensor values of the same bits."""
    return torch.tensor([v - (1 << 64) if v >= 1 << 63 else v
                         for v in seeds], dtype=torch.int64, device=device)


def _seeds_of(t):
    return [v % (1 << 64) for v in t.tolist()]


def _from_owner(owner, value, shape, dtype, home):
    """`value`, which the rank `owner` computed, on every rank."""
    rows = {0: value} if _dist.rank() == owner else {}
    return _dist.exchange(rows, [owner], shape, dtype, home)[0]


def _sharded_run(var_family, log_density, alpha, n, opt_param, source,
                 line, home):
    """A run's bound pass, PSIS and corrected moments split over `line`
    at the fitted `opt_param` (viabel_tpu/pipeline.py:202-245, 383-430).
    Returns `_bound_and_psis`'s reduced entries (on `home`) and the held
    shards' log-weights and smoothed log-weights."""
    moments = _closed_form_moments(var_family, opt_param, alpha)
    res = _pass(log_density, var_family, opt_param, n, source, line,
                float(alpha), home, moments=moments is None, psis=True,
                psis_moments=True)
    if moments is None:  # e.g. a t family with df <= 4: empirical C2/C4
        moments = torch.stack([res['C2'], res['C4']])
    q_mean, q_cov = var_family.mean_and_cov(opt_param)
    return (dict(opt_param=opt_param, q_mean=q_mean, q_cov=q_cov,
                 khat=res['khat'], psis_mean=res['psis_mean'],
                 psis_cov=res['psis_cov'], stats=res['stats'],
                 moments=moments), res['lw'], res['slw'])


def _validated_vi_mesh(obj, objective_and_grad, var_family, log_density,
                       n_iters, n_bound_samples, alpha, generator, window,
                       learning_rate, epsilon, learning_rate_end, init_param,
                       mesh, axis):
    """`validated_vi` on a mesh: the optimizer on the mesh's first device
    (its rank), its result and the bound pass's seed sent to every rank,
    then the pass split over `axis`."""
    first = mesh.entry({})
    home, dtype = init_param.device, init_param.dtype
    P = init_param.shape[0]
    pack = seed = None
    if first.rank == _dist.rank():
        opt_draws = generator
        if obj.presampled:
            opt_draws = map_draws(lambda v: v.to(home),
                                  objective_and_grad.make_draws(
                                      generator, n_iters, dtype))
        seed = _seeds_tensor([philox_seed(generator)], home)
        values, log_norms, opt_param = _optimize_and_average(
            obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
            init_param, opt_draws)
        pack = torch.cat([values, log_norms, opt_param])
    pack = _from_owner(first.rank, pack, (2 * n_iters + P,), dtype, home)
    seed = _seeds_of(_from_owner(first.rank, seed, (1,), torch.int64,
                                 home))[0]
    out, lw, slw = _sharded_run(var_family, log_density, alpha,
                                n_bound_samples, pack[2 * n_iters:], seed,
                                mesh.line(axis), home)
    placed = lambda parts: Sharded(mesh, (axis,), (n_bound_samples,),
                                   dtype, {(i,): p for i, p in parts.items()})
    return dict(value_history=pack[:n_iters],
                log_norm_history=pack[n_iters:2 * n_iters],
                log_weights=placed(lw), smoothed_log_weights=placed(slw),
                **out)


# the per-run entries of a batch that every rank receives, in pack order
_RUN_ENTRIES = ('value_history', 'log_norm_history', 'opt_param', 'q_mean',
                'q_cov', 'khat', 'psis_mean', 'psis_cov', 'stats',
                'moments')


def _run_sizes(n_iters, P, d):
    return (n_iters, n_iters, P, d, d * d, 1, d, d * d, 5, 2)


def _run_pack(opt, runs, n_iters, dtype):
    """The runs' `_RUN_ENTRIES` as one ``(runs, sum(_run_sizes))`` block
    on `opt`'s device: `opt` holds each run's histories and fit, and
    `runs` each run's reduced entries."""
    device = opt.device
    return torch.stack([torch.cat(
        [opt[j, :2 * n_iters]]
        + [run[key].reshape(-1).to(device, dtype)
           for key in _RUN_ENTRIES[2:]])
        for j, run in enumerate(runs)])


def _batch_mesh(objective_and_grad, has_log_norm, var_family, log_density,
                n_iters, window, lr_tables, epsilon, alpha, n_bound_samples,
                init_params, run_source, mesh, axis, sample_axis, sharded,
                bound_source=None):
    """The pipeline of K runs on a mesh (viabel_tpu/pipeline.py:383-445,
    447-510): the runs split over the `axis` groups, each group's K / C
    runs one batched optimizer on its first device, then each run's bound
    pass on that device or, when `sharded`, over the group's
    `sample_axis` line.

    Every group this rank holds starts its optimizer before any waits for
    a device, and the groups' results cross ranks in one
    `distributed.exchange` (two more before the sharded passes: the fits
    and the passes' seeds).  In one process the groups still ran mostly
    in turn on four cards (PERF.md, section 5): with one graph replay an
    iteration, the host likely waits for room in a card's launch queue
    before it reaches the next group.

    ``run_source(k, device)`` gives run k's optimizer draws (a presampled
    block, or a generator) and its bound pass's source (base draws, or
    with `sharded` a seed) on the device of run k's group; the group's
    rank calls it.  With `sharded`, `bound_source(k)`, when given, gives
    run k's bound source on every rank; else the group's rank sends its
    seeds to the others.  Every rank receives every run's reduced entries
    (`_RUN_ENTRIES`); the log-weights stay where they were computed, as a
    `Sharded` (K, n) array.  Returns `_batch_core`'s dict.
    """
    K, P = init_params.shape
    dtype, home, d = init_params.dtype, mesh.home(), var_family.dim
    presampled = getattr(objective_and_grad, 'presampled', False)
    tail_len = _tail_len(n_bound_samples, 1.0)
    sizes = _run_sizes(n_iters, P, d)
    groups = chain_groups(mesh, K, axis)
    per = K // len(groups)
    owners = [entry.rank for _, _, entry in groups]
    held = {g: entry.device for g, (_, _, entry) in enumerate(groups)
            if entry.rank == _dist.rank()}
    opts, bounds, pending = {}, {}, []
    for g, dev in held.items():
        lo, hi, _ = groups[g]
        with on_device(dev):
            sources = [run_source(k, dev) for k in range(lo, hi)]
            draws = [src[0] for src in sources]
            values, log_norms, _, opt = _adagrad_runs(
                objective_and_grad, has_log_norm, n_iters, window,
                lr_tables[lo:hi].to(dev), epsilon, init_params[lo:hi].to(dev),
                stack_draws(draws) if presampled else draws, pending=pending)
            opts[g] = torch.cat([values, log_norms, opt], dim=1)
            bounds[g] = [src[1] for src in sources]
    for counter, end in pending:
        _check_ran(counter, end)
    lw_blocks, slw_blocks = {}, {}
    if not sharded:
        local = {}
        for g, dev in held.items():
            with on_device(dev):
                runs = []
                for j, bound in enumerate(bounds[g]):
                    run = _bound_and_psis(var_family, log_density, alpha,
                                          tail_len, opts[g][j, 2 * n_iters:],
                                          bound)
                    lw_blocks.setdefault((g,), []).append(
                        run.pop('log_weights'))
                    slw_blocks.setdefault((g,), []).append(
                        run.pop('smoothed_log_weights'))
                    runs.append(run)
                local[g] = _run_pack(opts[g], runs, n_iters, dtype)
        flat = torch.cat(_dist.exchange(local, owners, (per, sum(sizes)),
                                        dtype, home))
    else:
        fits = _dist.exchange(opts, owners, (per, 2 * n_iters + P), dtype,
                              home)
        if bound_source is None:
            seeds = _seeds_of(torch.cat(_dist.exchange(
                {g: _seeds_tensor(b, held[g]) for g, b in bounds.items()},
                owners, (per,), torch.int64, home)))
            bound_source = seeds.__getitem__
        packs = []
        for g, (lo, hi, _) in enumerate(groups):
            line = mesh.line(sample_axis, {axis: g})
            runs = []
            for j in range(hi - lo):
                run, lw, slw = _sharded_run(
                    var_family, log_density, alpha, n_bound_samples,
                    fits[g][j, 2 * n_iters:], bound_source(lo + j), line,
                    home)
                for i in lw:
                    lw_blocks.setdefault((g, i), []).append(lw[i])
                    slw_blocks.setdefault((g, i), []).append(slw[i])
                runs.append(run)
            packs.append(_run_pack(fits[g], runs, n_iters, dtype))
        flat = torch.cat(packs)
    out, at = {}, 0
    for key, size in zip(_RUN_ENTRIES, sizes):
        block = flat[:, at:at + size]
        at += size
        out[key] = (block[:, 0] if key == 'khat' else
                    block.reshape(K, d, d) if key in ('q_cov', 'psis_cov')
                    else block)
    spec = (axis, sample_axis) if sharded else (axis,)
    for key, blocks in (('log_weights', lw_blocks),
                        ('smoothed_log_weights', slw_blocks)):
        out[key] = Sharded(mesh, spec, (K, n_bound_samples), dtype,
                           {c: torch.stack(v) for c, v in blocks.items()})
    return out


def _setup(log_density, var_family, init_param, objective_and_grad,
           n_mc_samples, generator, mesh, device):
    """The entry points' common defaults: the device (None: the CUDA card;
    with a mesh, this rank's home device of it), a generator of seed 0
    there, presampled KLVI on (`var_family`, `log_density`,
    `n_mc_samples`), and the init on that device."""
    if mesh is not None:
        device = mesh.home()
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    if objective_and_grad is None:
        objective_and_grad = black_box_klvi(
            var_family, log_density, n_mc_samples,
            presampled=var_family.base_sample is not None)
    return (device, generator, objective_and_grad,
            torch.as_tensor(init_param, device=device))


def validated_vi(log_density, var_family, init_param, n_iters, *,
                 objective_and_grad=None, n_mc_samples=100,
                 n_bound_samples=1000000, alpha=2.0, generator=None,
                 has_log_norm=None, window=10, learning_rate=0.01,
                 epsilon=0.1, learning_rate_end=None, log_norm_bound=None,
                 mesh=None, axis='sample', device=None):
    """The validated-VI pipeline: windowed adagrad, error bounds from
    `n_bound_samples` Monte Carlo log-weights, and PSIS-corrected moments
    (viabel_tpu/pipeline.py:247-346).

    `log_density` is a `models.Model` or a batched log-density callable;
    a Model whose `kernel` names a CUDA log density is scored by the fused
    bound-pass kernel.  The objective defaults to KLVI on
    (`var_family`, `log_density`, `n_mc_samples`), presampled when the
    family has a `base_sample`.  Runs on `device` (None: the CUDA card)
    with `generator` (default: seed 0 there), which draws the optimizer's
    draws first and the bound pass's base draws second.

    With `mesh` (a `parallel.Mesh` with an `axis`, default ``sample``,
    that divides `n_bound_samples`) the optimizer runs once, on the
    mesh's first device, and the bound pass, PSIS and the corrected
    moments split over `axis` (`parallel.sharded_bounds`): shard i draws
    from a generator seeded with ``fold_in(seed, i)``, `seed` drawn from
    `generator` after the optimizer's presampled draws, and the
    log-weights come back as `parallel.Sharded` arrays; `device` is then
    this rank's first device of the mesh.

    Returns a dict with ``opt_param``, ``value_history``,
    ``log_norm_history``, ``q_mean``, ``q_cov``, ``log_weights``,
    ``smoothed_log_weights``, ``psis_mean``, ``psis_cov`` (tensors),
    ``khat`` (float) and ``bounds`` (the `all_bounds` dict).
    """
    with span('fit'):
        if mesh is not None:
            _check_sample_axis(mesh, axis, n_bound_samples)
        _, generator, objective_and_grad, init_param = _setup(
            log_density, var_family, init_param, objective_and_grad,
            n_mc_samples, generator, mesh, device)
        obj = _wrap_objective(objective_and_grad, has_log_norm)
        if mesh is not None:
            out = _validated_vi_mesh(
                obj, objective_and_grad, var_family, log_density, n_iters,
                n_bound_samples, alpha, generator, window, learning_rate,
                epsilon, learning_rate_end, init_param, mesh, axis)
        else:
            with span('draws', init_param.device):
                opt_draws = generator
                if obj.presampled:
                    opt_draws = objective_and_grad.make_draws(
                        generator, n_iters, init_param.dtype)
                bound_draws = var_family.base_sample(
                    generator, n_bound_samples, init_param.dtype)
            out = _pipeline_core(obj, var_family, log_density, n_iters,
                                 window, learning_rate, epsilon,
                                 learning_rate_end, alpha,
                                 _tail_len(n_bound_samples, 1.0), init_param,
                                 opt_draws, bound_draws)
        bounds, khat, diverged = _assemble_bounds(
            out.pop('stats'), out.pop('moments'), out['khat'], out['q_cov'],
            n_bound_samples, alpha, log_norm_bound)
        # the divergence signal is non-finite LOG-WEIGHT STATISTICS: khat =
        # inf is also the legitimate short-tail outcome of a tiny, healthy
        # bound pass
        if diverged:
            warnings.warn(
                'the optimizer run diverged (non-finite log-weights at the '
                'fitted parameter): bounds are vacuous. Reduce the learning '
                'rate', DivergedRunWarning, stacklevel=2)
        out['bounds'] = bounds
        out['khat'] = khat
        return out


def _assemble_bounds(stats, moments, khat, q_cov, n, alpha, log_norm_bound):
    """Host-side `all_bounds` from the reduced tensors, one ``.cpu()``
    each (viabel_tpu/pipeline.py:349-378).  A diverged run (non-finite
    statistics or covariance) degrades to infinite bounds instead of
    raising.  Returns ``(bounds, khat, diverged)``."""
    with span('host_bounds'):
        stats = dict(zip(STAT_KEYS, to_host(stats).tolist()), n=n)
        c2, c4 = to_host(moments).tolist()
        khat = float(to_host(khat))
        q_cov = to_host(q_cov).numpy()
        if not np.all(np.isfinite(q_cov)):
            q_cov = np.inf
        finite_stats = all(np.isfinite(stats[k]) for k in STAT_KEYS)
        if finite_stats:
            d2, log_norm_bound = divergence_bound(
                None, alpha=alpha, log_norm_bound=log_norm_bound,
                return_log_norm_bound=True, _stats=stats)
        else:
            d2 = np.inf
            if log_norm_bound is None:
                log_norm_bound = -np.inf
        bounds = {}
        if alpha == 2:
            moments = {2: c2, 4: c4}
            moment_fn = (moments.get if np.isfinite(c2) and np.isfinite(c4)
                         else lambda p: np.inf)
            bounds = wasserstein_bounds(d2 if np.isfinite(d2) else np.inf,
                                        moment_bound_fn=moment_fn)
            bounds.update(error_bounds(q_var=q_cov, **bounds))
        bounds['d2' if alpha == 2 else 'dalpha'] = d2
        bounds['log_norm_bound'] = log_norm_bound
        return bounds, khat, not finite_stats


def _finalize_batch(out, n_bound_samples, alpha, log_norm_bound):
    """Host assembly for a batch (viabel_tpu/pipeline.py:657-689): each
    run's bounds and khat, and ``best``, the run of the smallest finite
    validated divergence bound (ties to the lowest index; when every run
    diverged, run 0, with one `DivergedRunWarning`)."""
    stats, moments = out.pop('stats'), out.pop('moments')
    bounds, khats, diverged = [], [], []
    for k in range(stats.shape[0]):
        b, kh, dv = _assemble_bounds(stats[k], moments[k], out['khat'][k],
                                     out['q_cov'][k], n_bound_samples,
                                     alpha, log_norm_bound)
        bounds.append(b)
        khats.append(kh)
        diverged.append(dv)
    d_key = 'd2' if alpha == 2 else 'dalpha'
    d_vals = np.asarray([b[d_key] for b in bounds], dtype=float)
    out['bounds'] = bounds
    out['khat'] = khats
    out['best'] = int(np.argmin(np.where(np.isfinite(d_vals), d_vals,
                                         np.inf)))
    if all(diverged):
        warnings.warn(
            'every run in this batch diverged (non-finite log-weights): '
            'bounds are vacuous and `best` is arbitrary. Reduce the '
            'learning rate or switch objective (CHIVI at large d: see '
            'benchmarks/DIM_SCALING.md)', DivergedRunWarning, stacklevel=3)
    return out


def validated_vi_multistart(log_density, var_family, init_param, n_iters, *,
                            n_starts=4, perturb_scale=0.5, init_params=None,
                            objective_and_grad=None, n_mc_samples=100,
                            n_bound_samples=1000000, alpha=2.0,
                            generator=None, has_log_norm=None, window=10,
                            learning_rate=0.01, epsilon=0.1,
                            learning_rate_end=None, log_norm_bound=None,
                            mesh=None, axis='chain', sample_axis='sample',
                            device=None):
    """K independent validated-VI runs as one batch
    (viabel_tpu/pipeline.py:560-654).

    Start 0 runs from `init_param` unperturbed, start o >= 1 from ``init +
    N(0, 1) (o + 1) perturb_scale``, unless explicit `init_params` (K, P)
    are given.  From `generator` (default: seed 0 on `device`, None: the
    CUDA card) come a seed for the perturbation noise (a Philox stream, so
    the CPU and the card perturb alike) and then a seed for each start;
    start k's generator draws its optimizer draws and then its bound
    pass's base draws, so start k is `validated_vi` with that generator
    and its init.  The K optimizer runs go at once, one batched step and
    one step-kernel launch an iteration; the bound passes run in turn.
    `n_bound_samples` is per start.

    With `mesh` the starts split over its `axis` (default ``chain``, which
    must divide K): each device group runs its K / C starts as one batch
    on its first device, drawing each start's draws there from the
    start's seed (the same draws as without a mesh, on the same kind of
    device).  Where the mesh also has a `sample_axis` of more than one
    member, which must divide `n_bound_samples`, each start's bound pass
    splits over the group's members, from a seed its generator gives
    after its optimizer's draws; ``sample_axis=None`` keeps the passes
    whole.  The log-weights then come back as a `parallel.Sharded` (K, n)
    array, every other entry on every rank.

    Returns a dict like `validated_vi`'s with a leading start axis on
    every tensor, ``bounds`` a list of K dicts, ``khat`` a list of K
    floats, and ``best`` the index of the start with the smallest finite
    validated divergence bound.
    """
    with span('fit'):
        device, generator, objective_and_grad, init_param = _setup(
            log_density, var_family, init_param, objective_and_grad,
            n_mc_samples, generator, mesh, device)
        dtype = init_param.dtype
        presampled = getattr(objective_and_grad, 'presampled', False)
        with span('draws', device):
            perturb_seed = philox_seed(generator)
            if init_params is None:
                noise = philox_normal(n_starts, init_param.shape[0],
                                      perturb_seed, dtype=dtype, device=device)
                init_params = _perturbed_inits(init_param, n_starts,
                                               perturb_scale, noise)
            else:
                init_params = torch.as_tensor(init_params, device=device)
                n_starts = init_params.shape[0]
            seeds = [philox_seed(generator) for _ in range(n_starts)]
            if mesh is None:
                generators = [torch.Generator(device=device).manual_seed(s)
                              for s in seeds]
                opt_draws = (stack_draws([objective_and_grad.make_draws(
                    g, n_iters, dtype) for g in generators])
                    if presampled else generators)
                bound_draws = stack_draws([var_family.base_sample(
                    g, n_bound_samples, dtype) for g in generators])
        lr_tables = _learning_rates(n_iters, learning_rate, learning_rate_end,
                                    dtype).repeat(n_starts, 1)
        if mesh is not None:
            sharded = _check_run_axis(
                mesh, axis, sample_axis, n_starts, n_bound_samples,
                'multistart partitions starts', 'n_starts')

            def run_source(k, dev):
                g = torch.Generator(device=dev).manual_seed(seeds[k])
                opt = (objective_and_grad.make_draws(g, n_iters, dtype)
                       if presampled else g)
                bound = (philox_seed(g) if sharded else
                         var_family.base_sample(g, n_bound_samples, dtype))
                return opt, bound

            out = _batch_mesh(objective_and_grad, has_log_norm, var_family,
                              log_density, n_iters, window, lr_tables,
                              epsilon, alpha, n_bound_samples, init_params,
                              run_source, mesh, axis, sample_axis, sharded)
        else:
            out = _batch_core(objective_and_grad, has_log_norm, var_family,
                              log_density, n_iters, window, lr_tables,
                              epsilon, alpha,
                              _tail_len(n_bound_samples, 1.0), init_params,
                              opt_draws, bound_draws)
        return _finalize_batch(out, n_bound_samples, alpha, log_norm_bound)


def _sweep_rates(learning_rates, learning_rate_ends=None):
    """The sweep's rates as float64 arrays, checked as the JAX package
    checks them (viabel_tpu/pipeline.py:757-770)."""
    lrs = np.asarray(learning_rates, dtype=np.float64)
    if lrs.ndim != 1 or lrs.size == 0:
        raise ValueError('learning_rates must be a non-empty 1-D array')
    if np.any(lrs <= 0):
        raise ValueError('learning rates must be positive')
    lr_ends = None
    if learning_rate_ends is not None:
        lr_ends = np.asarray(learning_rate_ends, dtype=np.float64)
        if lr_ends.shape != lrs.shape:
            raise ValueError('learning_rate_ends must match learning_rates')
        if np.any(lr_ends <= 0) or np.any(lrs <= lr_ends):
            raise ValueError('each end rate must satisfy '
                             '0 < learning_rate_end < learning_rate')
    return lrs, lr_ends


def validated_vi_sweep(log_density, var_family, init_param, n_iters, *,
                       learning_rates, learning_rate_ends=None,
                       objective_and_grad=None, n_mc_samples=100,
                       n_bound_samples=100000, alpha=2.0, generator=None,
                       has_log_norm=None, window=10, epsilon=0.1,
                       log_norm_bound=None, mesh=None, axis='chain',
                       sample_axis='sample', device=None):
    """A learning-rate sweep: the validated pipeline once a rate, as one
    batch, and which rate's fit carries the tightest validated bound
    (viabel_tpu/pipeline.py:748-836).

    Every rate runs from `init_param` on the same draws (common random
    numbers: `generator`, default seed 0 on `device`, draws the optimizer's
    draws and then the bound pass's base draws once, as `validated_vi`
    does, and every rate takes them), so the differences between rates
    are the rate's alone.  An objective that samples from a generator gets
    one copy of the generator's state a rate.  `learning_rates` must be
    positive; `learning_rate_ends` (optional) match them in shape, each
    in ``(0, rate)``.  With `mesh` the rates split over its `axis`, and
    each rate's bound pass over `sample_axis`, as the starts of
    `validated_vi_multistart` do; every group takes the shared draws on
    its device, and a sharded bound pass draws from one seed `generator`
    gives after the optimizer's draws, shared by every rate.

    Returns `validated_vi_multistart`'s dict with a leading rate axis, plus
    ``learning_rates`` echoed.
    """
    lrs, lr_ends = _sweep_rates(learning_rates, learning_rate_ends)
    sharded = mesh is not None and _check_run_axis(
        mesh, axis, sample_axis, lrs.size, n_bound_samples,
        'sweep partitions rates', 'the number of learning rates')
    device, generator, objective_and_grad, init_param = _setup(
        log_density, var_family, init_param, objective_and_grad,
        n_mc_samples, generator, mesh, device)
    dtype, K = init_param.dtype, lrs.size
    lr_tables = torch.stack([
        _learning_rates(n_iters, lr, None if lr_ends is None else lr_ends[k],
                        dtype) for k, lr in enumerate(lrs)])
    if mesh is not None:
        out = _sweep_mesh(objective_and_grad, has_log_norm, var_family,
                          log_density, n_iters, window, lr_tables, epsilon,
                          alpha, n_bound_samples, init_param, generator,
                          mesh, axis, sample_axis, sharded)
        out = _finalize_batch(out, n_bound_samples, alpha, log_norm_bound)
        out['learning_rates'] = lrs
        return out

    def shared(block):
        return map_draws(lambda v: v.expand(K, *v.shape), block)

    presampled = getattr(objective_and_grad, 'presampled', False)
    if presampled:
        opt_draws = shared(objective_and_grad.make_draws(generator, n_iters,
                                                         dtype))
    bound_draws = shared(var_family.base_sample(generator, n_bound_samples,
                                                dtype))
    if not presampled:  # the state validated_vi's optimizer would start at
        opt_draws = []
        for _ in range(K):
            opt_draws.append(torch.Generator(device=device))
            opt_draws[-1].set_state(generator.get_state())
    out = _batch_core(objective_and_grad, has_log_norm, var_family,
                      log_density, n_iters, window, lr_tables, epsilon,
                      alpha, _tail_len(n_bound_samples, 1.0),
                      init_param.repeat(K, 1), opt_draws, bound_draws)
    out = _finalize_batch(out, n_bound_samples, alpha, log_norm_bound)
    out['learning_rates'] = lrs
    return out


def _sweep_mesh(objective_and_grad, has_log_norm, var_family, log_density,
                n_iters, window, lr_tables, epsilon, alpha, n_bound_samples,
                init_param, generator, mesh, axis, sample_axis, sharded):
    """`validated_vi_sweep` on a mesh: the shared draws made once on this
    rank's home device (every rank makes the same) and moved once to each
    group's device; `_batch_mesh` runs the rates."""
    dtype, K = init_param.dtype, lr_tables.shape[0]
    presampled = getattr(objective_and_grad, 'presampled', False)
    opt_block = (objective_and_grad.make_draws(generator, n_iters, dtype)
                 if presampled else None)
    bound = (philox_seed(generator) if sharded else
             var_family.base_sample(generator, n_bound_samples, dtype))
    state = generator.get_state()
    moved = {}

    def on(device):
        if device not in moved:
            moved[device] = tuple(
                None if block is None else map_draws(
                    lambda v: v.to(device), block)
                for block in (opt_block, None if sharded else bound))
        return moved[device]

    def run_source(k, device):
        opt, block = on(device)
        if not presampled:
            opt = torch.Generator(device=device)
            opt.set_state(state)
        return opt, bound if sharded else block

    return _batch_mesh(objective_and_grad, has_log_norm, var_family,
                       log_density, n_iters, window, lr_tables, epsilon,
                       alpha, n_bound_samples, init_param.repeat(K, 1),
                       run_source, mesh, axis, sample_axis, sharded,
                       (lambda k: bound) if sharded else None)
