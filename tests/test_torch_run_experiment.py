"""The port's `run_experiment` against viabel_tpu.experiments.run_experiment,
float64, on shared draws.

The JAX package splits its key into KLVI's and CHIVI's
(viabel_tpu/experiments.py:374), and each of those into the optimizer's,
the bound pass's and PSIS's (viabel_tpu/experiments.py:298).  Those six
streams' draws (the presampled objectives' blocks and the passes' base
draws z) go through `interop` into the port's stages, on the protocol of
examples/eight_schools.py and examples/funnel.py cut to 300 iterations and
2e4 bound and PSIS samples.  Every fit, history, bound and PSIS result is
compared at rtol 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import models as jmodels
from viabel_tpu.experiments import run_experiment as j_run
from viabel_tpu_torch import interop
from viabel_tpu_torch import models as tmodels
from viabel_tpu_torch.experiments import _run_stages, _split

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning',
    'ignore::viabel_tpu.bounds.MonteCarloErrorWarning')

N_ITERS, N_SAMPLES = 300, 20000
KW = dict(n_iters=N_ITERS, bound_w2=N_SAMPLES, n_psis_samples=N_SAMPLES,
          learning_rate=.01, learning_rate_end=.001)
RTOL = 1e-8


def _setup(name):
    """(JAX model, port model, d, init) of each example."""
    if name == 'funnel':
        return (jmodels.funnel_model(), tmodels.funnel_model(), 2,
                np.array([0.0, -1.0, 1.0, 1.0]))
    jm = getattr(jmodels, 'eight_schools_{}_model'.format(name))()
    tm = getattr(tmodels, 'eight_schools_{}_model'.format(name))()
    init = np.array(vt.init_from_moments(
        vt.mean_field_t_variational_family(10, 40), jm.true_mean,
        jm.true_cov))
    return jm, tm, 10, init


def _streams(jobj, jfam, key):
    opt_key, bound_key, psis_key = jax.random.split(key, 3)
    return (interop.presampled_draws(jobj.make_draws(opt_key, N_ITERS,
                                                     jnp.float64)),
            interop.base_draws(jfam.base_sample(bound_key, N_SAMPLES,
                                                jnp.float64)),
            interop.base_draws(jfam.base_sample(psis_key, N_SAMPLES,
                                                jnp.float64)))


@pytest.fixture(scope='module', params=['ncp', 'funnel', 'cp'])
def runs(request):
    jm, tm, d, init = _setup(request.param)
    jfam = vt.mean_field_t_variational_family(d, 40)
    key = jax.random.PRNGKey(7)
    jout = j_run(jm.log_prob, jfam, jnp.asarray(init), jm.true_mean,
                 jm.true_cov, plot_contours=False, key=key, unroll=1, **KW)
    kl_key, chivi_key = jax.random.split(key)
    tfam = pt.mean_field_t_variational_family(d, 40)
    klvi = pt.black_box_klvi(tfam, tm, 100, presampled=True)
    chivi = pt.black_box_chivi(2, tfam, tm, 500, presampled=True)
    tout = _run_stages(tm, tfam, klvi, chivi, torch.as_tensor(init),
                       tm.true_mean, tm.true_cov,
                       _streams(jout[0], jfam, kl_key),
                       _streams(jout[1], jfam, chivi_key), **KW)
    return jout, tout


@pytest.mark.parametrize('stage', [2, 3])
def test_accuracy_results_match_jax(runs, stage):
    jout, tout = runs
    assert set(tout[stage]) == set(jout[stage])
    assert tout[stage]['method'] == jout[stage]['method']
    for k, v in jout[stage].items():
        if k != 'method':
            np.testing.assert_allclose(tout[stage][k], v, rtol=RTOL,
                                       err_msg=k)


@pytest.mark.parametrize('stage', [4, 5])
def test_fit_histories_bounds_and_psis_match_jax(runs, stage):
    jout, tout = runs
    want, got = jout[stage], tout[stage]
    assert set(got) == set(want) | {'seconds'}
    assert set(got['seconds']) == {'optimize', 'bounds', 'psis'}
    for k in ('opt_param', 'var_param_history', 'value_history'):
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-12,
                                   err_msg=k)
    for k in ('d2', 'W1', 'W2', 'mean_error', 'std_error', 'cov_error',
              'log_norm_bound'):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert set(got['psis_results']) == set(want['psis_results'])
    for k, v in want['psis_results'].items():
        np.testing.assert_allclose(got['psis_results'][k], v, rtol=RTOL,
                                   err_msg=k)


def test_chivi_takes_klvi_log_norm_bound_as_its_elbo(runs):
    _, tout = runs
    assert tout[5]['log_norm_bound'] == tout[4]['log_norm_bound']


def _small(generator, **kw):
    _, tm, _, init = _setup('ncp')
    fam = pt.mean_field_t_variational_family(10, 40)
    return pt.run_experiment(
        tm, fam, init, tm.true_mean, tm.true_cov, generator=generator,
        device='cpu', n_iters=60, bound_w2=3000, n_psis_samples=3000,
        learning_rate=.01, **kw)


def test_run_experiment_on_its_own_draws_is_finite_and_seeded(capsys):
    out = _small(torch.Generator().manual_seed(0))
    again = _small(torch.Generator().manual_seed(0))
    other = _small(torch.Generator().manual_seed(1))
    log = capsys.readouterr().out
    for banner in ('KLVI', 'CHIVI', 'PSIS-corrected moments'):
        assert '======== {} ========'.format(banner) in log
    assert 'bound estimation (CUBO + ELBO, 3,000 MC samples) took' in log
    assert out[0].presampled and out[1].has_log_norm
    for i in (4, 5):
        np.testing.assert_array_equal(out[i]['opt_param'],
                                      again[i]['opt_param'])
        assert not np.array_equal(out[i]['opt_param'],
                                  other[i]['opt_param'])
        assert np.all(np.isfinite(out[i]['value_history']))
        for k in ('d2', 'W2', 'log_norm_bound'):
            assert np.isfinite(out[i][k]), k
        assert np.isfinite(out[i]['psis_results']['khat'])
    assert out[3]['method'] == 'CHIVI'


def test_generator_splits_into_distinct_deterministic_streams():
    gens = _split(torch.Generator().manual_seed(0), 2)
    seeds = [g.initial_seed() for parent in gens for g in _split(parent, 3)]
    again = [g.initial_seed()
             for parent in _split(torch.Generator().manual_seed(0), 2)
             for g in _split(parent, 3)]
    assert seeds == again and len(set(seeds)) == 6


def test_options_that_are_not_ported_raise():
    """Every option of `run_experiment` is ported: ``plot_contours=True``
    draws the contours at the init and after each bound pass, and each
    fit's history and distance to its final parameter (on the 2-D funnel,
    headless), and changes no number; ``None`` plots a 2-D target."""
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    tm = tmodels.funnel_model()
    fam = pt.mean_field_t_variational_family(2, 40)
    init = np.array([0.0, -1.0, 1.0, 1.0])

    def run(plot_contours):
        return pt.run_experiment(
            tm, fam, init, tm.true_mean, tm.true_cov,
            generator=torch.Generator().manual_seed(3), device='cpu',
            n_iters=40, bound_w2=2000, n_psis_samples=2000,
            learning_rate=.01, plot_contours=plot_contours,
            contour_kws=dict(xlim=(-5, 5)))

    plt.close('all')
    quiet = run(False)
    assert plt.get_fignums() == []
    try:
        for plot_contours in (True, None):
            plotted = run(plot_contours)
            # the contours draw on the current figure, as the JAX
            # package's do: the init's opens one, and each stage adds its
            # history and distance figures
            assert len(plt.get_fignums()) == 5
            plt.close('all')
            for i in (4, 5):
                np.testing.assert_array_equal(plotted[i]['opt_param'],
                                              quiet[i]['opt_param'])
                assert plotted[i]['d2'] == quiet[i]['d2']
    finally:
        plt.close('all')
