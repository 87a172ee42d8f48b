"""Command-line interface: ``python -m viabel_tpu_torch <command>``.

PyTorch port of viabel_tpu/__main__.py:

* ``run`` — run a VI experiment from a config (flags or ``--config`` JSON),
  printing accuracy, bounds and khat; optional checkpointing
  (``--checkpoint-path``), the whole workflow as one pipeline call
  (``--fused``), the batched pipelines (``--starts``, ``--sweep-lr``);
* ``configs`` — print an example config with all fields;
* ``bench`` — the port's benchmark (`bench`): bench.py's configurations
  through the port on the card, and bench.py's JSON line with the card's
  numbers.

The flags, their validation messages and the printed lines are the JAX
package's, with two differences.  ``--device`` (default ``cuda``) names
the device, and without a card, and without ``--device cpu``, ``run``
and ``bench`` fail.  On the card ``run`` places a single run's work as
the JAX command line does, by `parallel.auto_mesh` over every rank's
cards (one card: no mesh and no line), and its ``mesh:`` or ``note:``
line says where; the batched pipelines (``--starts``, ``--sweep-lr``)
stay on one card, with a ``note:`` line where there are more
(`_report_batch`).  ``--device cpu`` runs on one device.

Examples
--------
python -m viabel_tpu_torch run --model funnel --n-iters 2000
python -m viabel_tpu_torch run --config my_experiment.json
python -m viabel_tpu_torch run --model funnel --n-iters 200 --device cpu
python -m viabel_tpu_torch configs
python -m viabel_tpu_torch bench
"""
import argparse
import dataclasses
import sys

import numpy as np
import torch

_NO_CARD = ('no CUDA device is available; pass --device cpu to run on the '
            'CPU')


def _device(args):
    """The device `args` names; a CUDA device without a card exits."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        sys.exit(_NO_CARD)
    from ._device import resolve_device
    return resolve_device(device)


def _mesh_devices(device):
    """The devices `auto_mesh` may place a run on: every rank's cards
    for a run on the card, none for a CPU run."""
    if device.type != 'cuda':
        return []
    from .parallel import devices
    return devices()


def _report_mesh(mesh, note, context=''):
    """Show `parallel.auto_mesh`'s placement, or why there is none
    (viabel_tpu/__main__.py:24-29): attached devices are never left out
    without a word."""
    if note:
        print(('mesh: ' if mesh is not None else 'note: ') + note + context)


def _report_batch(device):
    """A batch stays on one card: the batched optimizer is launch-bound,
    so a card runs 16 starts as fast as 4 and splitting them over cards
    gains nothing (PERF.md, section 5).  Where there are more cards, say so."""
    n = len(_mesh_devices(device))
    if n > 1:
        print('note: {} devices; the batch runs on one'.format(n))


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _khat_line(khat):
    khat = float(khat)
    return 'khat = {:.3f}{}'.format(
        khat, '  (> 0.7: unreliable)' if khat > 0.7 else '')


def _cmd_run(args):
    from .bounds import all_bounds, family_moment_bounds
    from .config import ExperimentConfig, build
    from .experiments import (_split, check_approx_accuracy,
                              get_samples_and_log_weights, print_bounds)
    from .psis import psislw

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
        overrides = {k: v for k, v in vars(args).items()
                     if k in fields and v is not None}
        cfg = ExperimentConfig(**overrides)
    print('config:', cfg.to_json())
    device = _device(args)

    model, family, objective = build(cfg)
    opt_gen, bound_gen, _ = _split(
        torch.Generator(device=device).manual_seed(cfg.seed), 3)
    init = family.init_param(device=device)

    n_starts = getattr(args, 'starts', None)
    sweep_lr = getattr(args, 'sweep_lr', None)
    # `is not None`: --starts 0 must reach the batched runner's validation
    if n_starts is not None or sweep_lr:
        return _run_batched(args, cfg, model, family, objective, opt_gen,
                            device)

    if getattr(args, 'fused', False):
        if cfg.optimizer != 'adagrad':
            sys.exit('--fused supports the adagrad optimizer only')
        if not cfg.bound_samples:
            sys.exit('--fused runs the bound stage inside the fused '
                     'program; --bound-samples must be > 0 (drop --fused '
                     'for an optimization-only run)')
        if cfg.checkpoint_path:
            sys.exit('--fused does not support --checkpoint-path (the '
                     'fused program is a single device call; use the '
                     'non-fused path for resumable runs)')
        from .parallel import auto_mesh
        from .pipeline import validated_vi
        # the bound pass, PSIS and the moments split over every card
        mesh, note = auto_mesh(1, cfg.bound_samples,
                               devices=_mesh_devices(device))
        _report_mesh(mesh, note)
        out = validated_vi(
            model, family, init, cfg.n_iters, objective_and_grad=objective,
            n_bound_samples=cfg.bound_samples, generator=opt_gen,
            learning_rate=cfg.learning_rate,
            learning_rate_end=cfg.learning_rate_end, mesh=mesh,
            device=device)
        values = _host(out['value_history'])
        print('final loss (tail mean): {:.6g}'.format(
            float(values[-max(len(values) // 10, 1):].mean())))
        print('posterior mean estimate:', np.round(_host(out['q_mean']), 4))
        if model.true_mean is not None:
            check_approx_accuracy(family, out['opt_param'],
                                  model.true_mean, model.true_cov,
                                  verbose=True)
        print_bounds(out['bounds'])
        print(_khat_line(out['khat']))
        print('PSIS-corrected mean:', np.round(_host(out['psis_mean']), 4))
        return

    from .config import fit as fit_config
    progress = cfg.optimizer == 'adagrad' and not cfg.checkpoint_path \
        and not args.quiet
    opt_param, values, ia_log = fit_config(cfg, model, family, objective,
                                           generator=opt_gen,
                                           progress=progress, device=device)
    if ia_log is not None:
        print('iterate-averaging start: mean iter {}, sigma iter {}'.format(
            ia_log['start_avg_mean_iters'], ia_log['start_avg_sigma_iters']))

    values = _host(values)
    print('final loss (tail mean): {:.6g}'.format(
        float(np.mean(values[-max(len(values) // 10, 1):]))))
    mean, cov = family.mean_and_cov(opt_param)
    print('posterior mean estimate:', np.round(_host(mean), 4))
    if model.true_mean is not None:
        check_approx_accuracy(family, opt_param, model.true_mean,
                              model.true_cov, verbose=True)

    if cfg.bound_samples:
        from .parallel import auto_mesh
        mesh, note = auto_mesh(1, cfg.bound_samples,
                               devices=_mesh_devices(device))
        _report_mesh(mesh, note, ' (bound stage)')
        # None for families without a finite closed-form 4th moment (t
        # with df <= 4): the bounds then use the samples' central moments
        mb = family_moment_bounds(family, opt_param)
        if mesh is not None:
            from .ops.philox import philox_seed
            from .parallel import psislw_sharded, sharded_all_bounds
            res, lw = sharded_all_bounds(
                model, family, opt_param, cfg.bound_samples,
                philox_seed(bound_gen), mesh, q_var=_host(cov),
                moment_bound_fn=mb, return_log_weights=True)
            khat = psislw_sharded(lw, mesh)[1]
        else:
            samples, lw = get_samples_and_log_weights(
                model, family, opt_param, cfg.bound_samples, bound_gen,
                device)
            res = all_bounds(lw, samples=samples if mb is None else None,
                             q_var=_host(cov), moment_bound_fn=mb)
            khat = psislw(lw)[1]
        print_bounds(res)
        print(_khat_line(khat))


def _run_batched(args, cfg, model, family, objective, opt_gen, device):
    """``run --starts K`` / ``run --sweep-lr a,b,c``: the batched pipelines
    `validated_vi_multistart` and `validated_vi_sweep` on one device
    (viabel_tpu/__main__.py:163-283, which places them on a mesh;
    `_report_batch` says why the port does not)."""
    from .experiments import check_approx_accuracy, print_bounds

    n_starts = getattr(args, 'starts', None)
    sweep_lr = getattr(args, 'sweep_lr', None)
    if n_starts and sweep_lr:
        sys.exit('--starts and --sweep-lr are mutually exclusive (one '
                 'batched pipeline per run)')
    if n_starts is not None and n_starts < 1:
        sys.exit('--starts must be a positive integer')
    if getattr(args, 'fused', False):
        print('note: --starts/--sweep-lr are already single-dispatch fused '
              'pipelines; --fused adds nothing here')
    if cfg.optimizer != 'adagrad':
        sys.exit('--starts/--sweep-lr run the batched adagrad pipelines; '
                 'set --optimizer adagrad (or drop --optimizer)')
    if not cfg.bound_samples:
        sys.exit('--starts/--sweep-lr validate every run with bounds; '
                 '--bound-samples must be > 0')
    if cfg.checkpoint_path:
        sys.exit('--starts/--sweep-lr are single-dispatch programs and do '
                 'not support --checkpoint-path')

    init = family.init_param(device=device)
    common = dict(objective_and_grad=objective,
                  n_bound_samples=cfg.bound_samples, generator=opt_gen,
                  device=device)

    if n_starts:
        from .pipeline import validated_vi_multistart
        _report_batch(device)
        out = validated_vi_multistart(
            model, family, init, cfg.n_iters, n_starts=n_starts,
            perturb_scale=args.perturb_scale,
            learning_rate=cfg.learning_rate,
            learning_rate_end=cfg.learning_rate_end, **common)
        labels = ['start {}{}'.format(k, ' (unperturbed)' if k == 0 else '')
                  for k in range(n_starts)]
    else:
        from .pipeline import validated_vi_sweep
        try:
            lrs = [float(v) for v in sweep_lr.split(',') if v]
        except ValueError:
            sys.exit('--sweep-lr takes a comma-separated list of rates, '
                     'e.g. --sweep-lr 0.1,0.03,0.01')
        if not lrs:
            sys.exit('--sweep-lr got an empty list of rates')
        lr_ends = None
        if args.sweep_lr_end:
            try:
                lr_ends = [float(v) for v in args.sweep_lr_end.split(',')
                           if v]
            except ValueError:
                sys.exit('--sweep-lr-end takes a comma-separated list')
            if len(lr_ends) != len(lrs):
                sys.exit('--sweep-lr-end must list one end rate per '
                         '--sweep-lr rate ({} given for {} rates)'.format(
                             len(lr_ends), len(lrs)))
        elif cfg.learning_rate_end is not None:
            # a single --learning-rate-end applies to every swept rate
            lr_ends = [cfg.learning_rate_end] * len(lrs)
        if lr_ends is not None:
            bad = [(e, l) for e, l in zip(lr_ends, lrs) if not 0 < e < l]
            if bad:
                sys.exit('each end rate must satisfy 0 < end < rate; got '
                         'end {:g} for rate {:g}'.format(*bad[0]))
        _report_batch(device)
        out = validated_vi_sweep(
            model, family, init, cfg.n_iters, learning_rates=lrs,
            learning_rate_ends=lr_ends, **common)
        labels = ['lr {:g}'.format(lr) for lr in lrs]

    values = _host(out['value_history'])
    for k, label in enumerate(labels):
        b, khat = out['bounds'][k], out['khat'][k]
        print('{:>22}: d2 = {:<10.4g} khat = {:+.3f}  final loss = '
              '{:.6g}'.format(label, b['d2'], khat,
                              float(values[k][-max(values.shape[1] // 10,
                                                   1):].mean())))
    best = out['best']
    print('best by validated d2 bound: {}'.format(labels[best]))
    print('posterior mean estimate:', np.round(_host(out['q_mean'][best]), 4))
    if model.true_mean is not None:
        check_approx_accuracy(family, out['opt_param'][best],
                              model.true_mean, model.true_cov, verbose=True)
    print_bounds(out['bounds'][best])
    print(_khat_line(out['khat'][best]))
    print('PSIS-corrected mean:',
          np.round(_host(out['psis_mean'][best]), 4))


def _cmd_bench(args):
    from .bench import main as bench_main
    bench_main(device=_device(args))


def _cmd_configs(args):
    from .config import ExperimentConfig
    print(ExperimentConfig().to_json())


def main(argv=None):
    p = argparse.ArgumentParser(prog='python -m viabel_tpu_torch')
    sub = p.add_subparsers(dest='cmd', required=True)

    # choices come from the config registries so the CLI cannot drift
    from .config import FAMILIES, MODELS, OBJECTIVES, OPTIMIZERS

    pr = sub.add_parser('run', help='run a VI experiment')
    pr.add_argument('--config', help='JSON config file')
    pr.add_argument('--model', choices=MODELS)
    pr.add_argument('--family', choices=FAMILIES)
    pr.add_argument('--objective', choices=OBJECTIVES)
    pr.add_argument('--optimizer', choices=OPTIMIZERS)
    pr.add_argument('--df', type=float)
    pr.add_argument('--alpha', type=float)
    pr.add_argument('--n-mc', dest='n_mc', type=int,
                    help='Monte Carlo samples per gradient (default 100, '
                         'the reference protocol)')
    pr.add_argument('--n-iters', dest='n_iters', type=int)
    pr.add_argument('--n-chains', dest='n_chains', type=int)
    pr.add_argument('--learning-rate', dest='learning_rate', type=float)
    pr.add_argument('--learning-rate-end', dest='learning_rate_end',
                    type=float)
    pr.add_argument('--seed', type=int)
    pr.add_argument('--bound-samples', dest='bound_samples', type=int)
    pr.add_argument('--no-presampled', dest='presampled',
                    action='store_const', const=False,
                    help='sample inside each optimizer step instead of '
                         'drawing all draws up front (saves the (n_iters, '
                         'n_mc, dim) block of draws, at lower it/s)')
    pr.add_argument('--checkpoint-path', dest='checkpoint_path')
    pr.add_argument('--quiet', action='store_true')
    pr.add_argument('--fused', action='store_true',
                    help='run the whole workflow (optimize + bounds + PSIS)'
                         ' as one pipeline call (validated_vi)')
    pr.add_argument('--starts', type=int,
                    help='run K complete validated pipelines from perturbed '
                         'inits as one batch (validated_vi_multistart) and '
                         'report the start with the tightest validated '
                         'bound')
    pr.add_argument('--perturb-scale', dest='perturb_scale', type=float,
                    default=0.5,
                    help='multistart init perturbation scale '
                         '(default 0.5, the reference scheme)')
    pr.add_argument('--sweep-lr', dest='sweep_lr',
                    help='comma-separated learning rates; runs the complete '
                         'validated pipeline once per rate as one batch '
                         '(validated_vi_sweep) with common random numbers '
                         'and reports the best rate')
    pr.add_argument('--sweep-lr-end', dest='sweep_lr_end',
                    help='comma-separated schedule end rates matching '
                         '--sweep-lr')
    pr.add_argument('--device', default='cuda',
                    help='the device to run on (default cuda; cpu runs the '
                         'kernels\' plain versions)')
    pr.set_defaults(fn=_cmd_run)

    pb = sub.add_parser('bench', help='benchmark the eight-schools story '
                        '(bench.py\'s configurations) on the card')
    pb.add_argument('--device', default='cuda',
                    help='the device to run on (default cuda; cpu runs the '
                         'kernels\' plain versions)')
    pb.set_defaults(fn=_cmd_bench)

    pc = sub.add_parser('configs', help='print an example config')
    pc.set_defaults(fn=_cmd_configs)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
