"""Every module of `viabel_tpu_torch.examples` runs its `main` on the CPU
at a smoke depth: the keys of the dict the JAX example returns (read from
examples/*.py), its printed lines, and finite values where the JAX
example's are finite (tests/test_examples.py's checks)."""
import functools

import numpy as np
import pytest

from viabel_tpu_torch import mcmc
from viabel_tpu_torch.examples import (MODULES, chivi_experiments,
                                       eight_schools, eight_schools_ia,
                                       funnel, large_d, linear_regression_ia,
                                       multistart_pipeline, normal_mixture,
                                       pod_layout, robust_regression)
from torch_examples_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

BOUND_KEYS = {'W1', 'W2', 'd2', 'log_norm_bound', 'mean_error', 'std_error',
              'cov_error'}


def test_the_package_lists_the_ten_modules():
    import os
    here = os.path.dirname(normal_mixture.__file__)
    assert sorted(MODULES) == sorted(
        f[:-3] for f in os.listdir(here)
        if f.endswith('.py') and not f.startswith('_'))
    assert len(MODULES) == 10


def test_normal_mixture_main(capsys):
    out = normal_mixture.main(device='cpu')
    assert set(out) == {'samples_only', 'q_var_lnb', 'analytic_mb',
                        'analytic_mb_ref_input'}
    for res in out.values():
        assert set(res) == BOUND_KEYS
        assert np.isfinite(res['W2']) and np.isfinite(res['d2'])
    assert '2-Wasserstein' in capsys.readouterr().out


def test_funnel_main():
    out = funnel.main(n_iters=100, mc_samples=5000, device='cpu')
    assert set(out) == {'khat_klvi', 'khat_chivi', 'klvi', 'chivi'}
    assert np.isfinite(out['khat_klvi']) and np.isfinite(out['khat_chivi'])


def test_eight_schools_main():
    out = eight_schools.main(n_iters=100, mc_samples=5000, device='cpu')
    assert set(out) == {'cp', 'ncp', 'truth'}
    assert set(out['truth']) == {'mean_cp', 'cov_cp', 'mean_ncp', 'cov_ncp'}
    for run in (out['cp'], out['ncp']):
        assert set(run) == {'khat_klvi', 'khat_chivi', 'out'}
        assert np.isfinite(run['khat_klvi'])


def test_robust_regression_main(capsys):
    out = robust_regression.main(n_iters=100, mc_samples=5000,
                                 device='cpu')
    assert set(out) == {'khat_full', 'W2_full', 'd2_full', 'mean_err_full',
                        'khat_klvi', 'khat_chivi'}
    assert np.isfinite(out['khat_full']) and out['W2_full'] > 0
    log = capsys.readouterr().out
    assert 'KLVI mf-t(40):' in log and 'full-rank KLVI:' in log


def test_multistart_pipeline_main(capsys):
    out = multistart_pipeline.main(n_iters=100, mc_samples=5000,
                                   n_starts=2, device='cpu')
    assert {'best', 'bounds', 'khat', 'psis_mean', 'opt_param'} <= set(out)
    assert np.isfinite(out['bounds'][out['best']]['d2'])
    text = capsys.readouterr().out
    assert 'best by validated d2' in text and 'PSIS-corrected mean' in text


def test_chivi_experiments_main(monkeypatch):
    """HMC cut to 60 warm-up transitions and 100 draws and its R-hat gate
    lifted for the smoke depth; every stage reports."""
    real = mcmc.hmc_ground_truth
    monkeypatch.setattr(chivi_experiments, 'hmc_ground_truth',
                        functools.partial(_short_hmc, real))
    out = chivi_experiments.main(n_iters=60, mc_samples=3000, device='cpu')
    assert set(out) == {'chivi_expts', 'chive_expts_2', 'chive_expts_3',
                        'perturbed_klvi'}
    assert set(out['chivi_expts']) == {'klvi', 'chivi mf-t(4.5) +0.1',
                                       'chivi mf-t(4.5) +1.4 (bad)'}
    assert 'param_move_rel' in out['chive_expts_3']['chivi_neff mf-t(8) +1.2']
    for proto in out.values():
        for stage in ([proto] if 'khat' in proto else proto.values()):
            assert not np.isnan(stage['khat'])
            assert np.isfinite(stage['mean_err'])


def _short_hmc(real, model, **kw):
    return real(model, **dict(kw, n_warmup=60, n_samples=100,
                              r_hat_tol=np.inf))


def _short_ia(real, n_iters, rhat_window):
    """The IA optimizer `real` cut to `n_iters` iterations, R-hat windows
    of `rhat_window` and a tail of a third, whatever depth it is asked
    for."""
    def run(_, *args, **kw):
        return real(n_iters, *args, **dict(kw, rhat_window=rhat_window,
                                           tail_avg_iters=n_iters // 3))
    return run


def test_linear_regression_ia_main_and_protocol2(monkeypatch, capsys):
    for name in ('rmsprop_IA_optimize_with_rhat',
                 'adam_IA_optimize_with_rhat'):
        monkeypatch.setattr(linear_regression_ia, name, _short_ia(
            getattr(linear_regression_ia, name), 200, 100))
    out = linear_regression_ia.main(device='cpu')
    assert set(out) == {(name, lr) for name in ('rmsprop', 'adam')
                        for lr in (0.02, 0.005)}
    for res in out.values():
        assert np.isfinite(res['psis_mean_error']) and \
            np.isfinite(res['khat'])
    monkeypatch.undo()
    two = linear_regression_ia.protocol2(n_iters=300, device='cpu')
    assert set(two['mf']) == {'klvi', 'klvi_pd2'}
    assert set(two['fr']) == {'rmsprop', 'adam'}
    for res in list(two['mf'].values()) + list(two['fr'].values()):
        assert all(np.isfinite(v) for v in res.values())
    text = capsys.readouterr().out
    assert 'klvi_pd2' in text and 'cov dist' in text


def test_eight_schools_ia_main(monkeypatch, capsys):
    monkeypatch.setattr(eight_schools_ia, 'rmsprop_IA_optimize_with_rhat',
                        _short_ia(eight_schools_ia.
                                  rmsprop_IA_optimize_with_rhat, 300, 60))
    eight_schools_ia.main(device='cpu')
    text = capsys.readouterr().out
    assert text.count('averaging starts') == 3
    assert 'IA at least as close' in text and 'IA cov err' in text
    monkeypatch.undo()
    log = eight_schools_ia.run_full_rank(n_iters=300, device='cpu')
    assert {'start_avg_mean_iters', 'start_avg_sigma_iters', 'r_hat_mean',
            'r_hat_sigma'} <= set(log)
    assert np.isfinite(log['ia_cov_err'])


def test_large_d_main(capsys):
    assert large_d.main(d=4, n_iters=200, device='cpu') in (0, 1)
    text = capsys.readouterr().out
    assert 'P = 14 variational parameters' in text
    assert 'validated fit:' in text


def test_pod_layout_main(capsys):
    out = pod_layout.main(['--quick', '--device', 'cpu', '--devices', '4'])
    text = capsys.readouterr().out
    assert '4-way sharded bound pass' in text
    assert '(2x2) mesh, 4 starts in one program' in text
    assert 'fetch_global -> host' in text
    assert np.isfinite(out['sharded']['d2']) and out['fetched'] == (8000,)
