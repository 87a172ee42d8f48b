"""CHIVI experiment protocols on synthetic correlated-design regressions
(examples/chivi_experiments.py; reference: notebooks/chivi_expts.ipynb,
chive_expts_2.ipynb, chive_expts_3.ipynb).

Each notebook runs the same protocol on a robust-regression posterior over
`data_generator_linear` data (seed 5080):

1. a ground truth from the in-repo HMC sampler (`mcmc.hmc_ground_truth`);
2. a KLVI fit with a mean-field t(10) family, n_mc = 100;
3. CHIVI warm-started from the KLVI solution with the log-scales inflated
   by a config-specific offset.

Configurations (notebook : data : CHIVI stage):

* chivi_expts   : N=60, k=10, rho=0.05 -- CHIVI mf-t(4.5), n_mc=500,
  "good" (+0.1) and "bad" (+1.4) offsets, 3000 iters;
* chive_expts_2 : N=80, k=14, rho=0.1 -- CHIVI mf-t(5), +0.6, 6000 iters,
  lr .01 -> .002;
* chive_expts_3 : N=90, k=30, rho=0.1 -- `black_box_chivi_neff` mf-t(8),
  +1.2, 1400 iters, lr .004 -> .0001.

Then the perturbed-objective KLVI (`perturbed_black_box_vi`, scale 0.05)
on the robust-regression notebook's data.  Posterior mean error and PSIS
khat are reported after every stage.  The "bad" +1.4 stage diverges: its
parameters turn NaN, and the stage reports ``mean_err = nan`` and a
non-finite khat instead of raising (benchmarks/CHIVI_PROTOCOLS.md).

The KLVI and CHIVI objectives are presampled (the draws of the JAX
example's key-threaded run; a replayed CUDA graph on the card); the
perturbed objective samples inside its step.  Each stage's generator is
``folded`` from its protocol's, as the JAX example folds its keys.  It
reaches K1 on the regression row model at d = 10, 14, 30 and 2 (and on
NaN parameters), K3, the combine and the adagrad step kernel.

    python -m viabel_tpu_torch.examples.chivi_experiments [--full]
        [--device cpu]
"""
import numpy as np
import torch

from ..experiments import get_samples_and_log_weights
from ..families import mean_field_t_variational_family
from ..mcmc import hmc_ground_truth
from ..models import data_generator_linear, robust_regression_model
from ..objectives import (black_box_chivi, black_box_chivi_neff,
                          black_box_klvi, perturbed_black_box_vi)
from ..optimizers import adagrad_optimize
from ..psis import psislw
from ._common import default_generator, folded, parser, resolve_device


def _fit_and_report(name, obj, init, n_iters, lr, lr_end, fam, model,
                    truth, mc_samples, key, dtype=torch.float32):
    """One stage: adagrad from `init` in `dtype`, then PSIS khat of
    `mc_samples` draws and the mean error against ``truth['mean']``.
    `key` is a generator (the optimizer's draws come from it, the bound
    pass's from ``folded(key, 1)``), or the pair ``(draws, log_weights)``
    they would give.  Returns ``(fit, {'mean_err', 'khat'})``."""
    if isinstance(key, torch.Generator):
        device, opt_src, lw = key.device, dict(generator=key), None
    else:
        (draws, lw), device = key, torch.as_tensor(key[1]).device
        opt_src = dict(draws=draws)
    opt, _, values, _ = adagrad_optimize(
        n_iters, obj, torch.as_tensor(np.asarray(init), dtype=dtype),
        learning_rate=lr, learning_rate_end=lr_end, device=device,
        **opt_src)
    mean, _ = fam.mean_and_cov(opt)
    if lw is None:
        _, lw = get_samples_and_log_weights(model, fam, opt, mc_samples,
                                            folded(key, 1), device=device)
    _, khat = psislw(torch.as_tensor(lw, device=device))
    mean_err = float(np.linalg.norm(mean.cpu().numpy() - truth['mean']))
    print('  {:>22}: mean_err = {:.4f}  khat = {:+.3f}  '
          'final loss = {:.5g}'.format(
              name, mean_err, float(khat),
              float(np.mean(values.cpu().numpy()[-50:]))), flush=True)
    return opt, dict(mean_err=mean_err, khat=float(khat))


def run_protocol(label, N, k, rho, chivi_cfgs, n_iters_klvi, mc_samples,
                 hmc_samples, seed_key, use_neff=False, noise_sigma=0.5,
                 alpha=1.0, truth=None, stage_keys=None,
                 dtype=torch.float32):
    """One notebook's protocol: data -> HMC truth -> KLVI -> CHIVI stages.

    `chivi_cfgs` is a list of ``(name, df, log_scale_offset, n_iters, lr,
    lr_end)`` CHIVI stages, each warm-started from the KLVI solution.
    `seed_key` is the protocol's generator: HMC takes ``folded(seed_key,
    0)``, KLVI ``folded(seed_key, 1)``, CHIVI stage i ``folded(seed_key,
    10 + i)``.  A given `truth` (``{'mean': ...}``) stands in for HMC, and
    `stage_keys(j)` for the generator of stage ``j`` (1, 10, 11, ...):
    `_fit_and_report`'s ``(draws, log_weights)`` pair, say.
    """
    print('== {} (N={}, k={}, rho={}) =='.format(label, N, k, rho))
    device = seed_key.device
    if stage_keys is None:
        stage_keys = lambda j: folded(seed_key, j)
    data = data_generator_linear(N, k, alpha=alpha,
                                 noise_variance=noise_sigma ** 2, rho=rho,
                                 seed=5080)
    model = robust_regression_model(data['X'], data['Y'], df=40.0)
    if truth is None:
        truth = hmc_ground_truth(model, generator=folded(seed_key, 0),
                                 n_samples=hmc_samples, n_warmup=1000,
                                 n_chains=4, device=device)
        print('  HMC truth: max R-hat = {:.4f}'.format(
            truth['diagnostics']['r_hat'].max()))

    results = {}
    fam_klvi = mean_field_t_variational_family(k, 10)
    klvi = black_box_klvi(fam_klvi, model, 100, presampled=True)
    init = np.concatenate([np.zeros(k), np.ones(k)])
    klvi_opt, results['klvi'] = _fit_and_report(
        'klvi mf-t(10)', klvi, init, n_iters_klvi, .01, .001, fam_klvi,
        model, truth, mc_samples, stage_keys(1), dtype)

    for i, (name, df, offset, n_it, lr, lr_end) in enumerate(chivi_cfgs):
        fam_c = mean_field_t_variational_family(k, df)
        factory = black_box_chivi_neff if use_neff else black_box_chivi
        obj = factory(2, fam_c, model, 500, presampled=True)
        warm = klvi_opt.cpu().numpy().copy()
        warm[k:] += offset
        stage_opt, results[name] = _fit_and_report(
            name, obj, warm, n_it, lr, lr_end, fam_c, model, truth,
            mc_samples, stage_keys(10 + i), dtype)
        if use_neff:
            # The ESS damping scales the CHIVI gradient by neff / n; with a
            # heavy right weight tail (khat >> 0.7 at the warm start)
            # neff / n ~ 0, so the stage can finish having barely moved,
            # and a small mean_err then reflects the KLVI warm start
            # (benchmarks/CHIVI_PROTOCOLS.md)
            move = float(np.linalg.norm(stage_opt.cpu().numpy() - warm))
            rel = move / max(float(np.linalg.norm(warm)), 1e-12)
            results[name]['param_move_rel'] = rel
            if rel < 0.01:
                print('  {:>22}  NOTE: stage effectively frozen by ESS '
                      'damping (parameters moved {:.2g} rel.; neff/n ~ 0 '
                      'at this khat) — mean_err above reflects the KLVI '
                      'warm start, not CHIVI'.format('', rel), flush=True)
    return results


def protocols(full=False, n_iters=None, mc_samples=None, hmc_samples=None,
              device=None):
    """The three notebooks' `run_protocol` calls as ``(name, args,
    kwargs)``, each with its generator (seeds 0, 1, 2) on `device`;
    `hmc_samples` (default 20000 with `full`, else 4000) is each
    protocol's HMC length."""
    scale = 1.0 if full else 0.2
    it = lambda n: n_iters or max(int(n * scale), 200)
    mc = mc_samples or (1000000 if full else 50000)
    hmc_n = hmc_samples or (20000 if full else 4000)
    return [
        # chivi_expts.ipynb: good against bad CHIVI init spread (cells
        # 20-27)
        ('chivi_expts', (
            'chivi_expts', 60, 10, 0.05,
            [('chivi mf-t(4.5) +0.1', 4.5, 0.1, it(3000), .01, None),
             ('chivi mf-t(4.5) +1.4 (bad)', 4.5, 1.4, it(3000), .01, None)],
            it(5000), mc, hmc_n, default_generator(device, 0)), {}),
        # chive_expts_2.ipynb: k = 14, a single good run (cells 16-17)
        ('chive_expts_2', (
            'chive_expts_2', 80, 14, 0.1,
            [('chivi mf-t(5) +0.6', 5, 0.6, it(6000), .01, .002)],
            it(5000), mc, hmc_n, default_generator(device, 1)), {}),
        # chive_expts_3.ipynb: k = 30, ESS-damped gradient (cells 30-31)
        ('chive_expts_3', (
            'chive_expts_3', 90, 30, 0.1,
            [('chivi_neff mf-t(8) +1.2', 8, 1.2, it(1400), .004, .0001)],
            it(6000), mc, hmc_n, default_generator(device, 2)),
         dict(use_neff=True)),
    ]


def perturbed_klvi(full=False, n_iters=None, mc_samples=None, device=None):
    """The perturbed-objective KLVI stage on the robust-regression
    notebook's data, from a generator of seed 3."""
    scale = 1.0 if full else 0.2
    n_it = n_iters or max(int(3000 * scale), 200)
    mc = mc_samples or (1000000 if full else 50000)
    print('== perturbed KLVI (robust-regression notebook data) ==')
    model = robust_regression_model()
    fam = mean_field_t_variational_family(2, 40)
    obj = perturbed_black_box_vi(fam, model, 100, perturbation_scale=0.05)
    truth = dict(mean=model.true_mean)
    return _fit_and_report('perturbed_klvi', obj, np.zeros(4), n_it, .01,
                           None, fam, model, truth, mc,
                           default_generator(device, 3))[1]


def main(full=False, n_iters=None, mc_samples=None, device=None):
    """The three protocols and the perturbed KLVI stage, float32, on
    `device` (None: the CUDA card).  Returns the JAX example's dict."""
    device = resolve_device(device)
    out = {}
    for name, args, kw in protocols(full, n_iters, mc_samples,
                                    device=device):
        out[name] = run_protocol(*args, **kw)
    out['perturbed_klvi'] = perturbed_klvi(full, n_iters, mc_samples,
                                           device)
    return out


if __name__ == '__main__':
    a = parser(__doc__.splitlines()[0]).parse_args()
    main(a.full, device=a.device)
