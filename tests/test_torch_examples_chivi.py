"""The port's CHIVI protocols (`viabel_tpu_torch.examples.
chivi_experiments`) against examples/chivi_experiments.py, float64 on the
CPU, on shared draws: each stage is fed the presampled block of the JAX
stage's key (`make_draws`, the draws of its key-threaded run) and the
log-weights the JAX stage drew; rtol 1e-10.  The JAX reference's adagrad
runs with ``unroll=1`` (a compile-time knob that changes no bit) to keep
its compile short.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import models as jmodels
from viabel_tpu.experiments import get_samples_and_log_weights as j_lw
from viabel_tpu_torch import interop
from viabel_tpu_torch import models as tmodels

from examples import chivi_experiments as j_ce
from viabel_tpu_torch.examples import chivi_experiments as t_ce
from torch_examples_helpers import close_dicts, one_thread, quiet  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning',
    'ignore::viabel_tpu.bounds.MonteCarloErrorWarning')

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _short_jax_compiles(monkeypatch):
    monkeypatch.setattr(j_ce, 'adagrad_optimize',
                        functools.partial(vt.adagrad_optimize, unroll=1))


def _stage_draws(fam, jm, n_iters, key, chivi=False, neff=False):
    make = (vt.black_box_chivi_neff if neff else vt.black_box_chivi) \
        if chivi else None
    obj = (make(2, fam, jm.log_prob, 500, presampled=True) if chivi else
           vt.black_box_klvi(fam, jm.log_prob, 100, presampled=True))
    return interop.presampled_draws(obj.make_draws(key, n_iters,
                                                   jnp.float64))


def test_fit_and_report_matches_jax_on_its_draws():
    data = jmodels.data_generator_linear(30, 3, seed=5080)
    jm = jmodels.robust_regression_model(data['X'], data['Y'])
    tm = tmodels.robust_regression_model(data['X'], data['Y'])
    jf = vt.mean_field_t_variational_family(3, 10)
    tf = pt.mean_field_t_variational_family(3, 10)
    key = jax.random.PRNGKey(7)
    truth = dict(mean=np.array([0.3, -0.2, 0.1]))
    init = np.concatenate([np.zeros(3), np.ones(3)])
    (jopt, want), want_log = quiet(
        j_ce._fit_and_report, 'klvi', vt.black_box_klvi(jf, jm.log_prob,
                                                        100),
        init, 120, .01, .001, jf, jm, truth, 4000, key)
    lw = np.asarray(j_lw(jm.log_prob, jf, jopt, 4000,
                         jax.random.fold_in(key, 1))[1])
    (topt, got), got_log = quiet(
        t_ce._fit_and_report, 'klvi',
        pt.black_box_klvi(tf, tm, 100, presampled=True), init, 120, .01,
        .001, tf, tm, truth, 4000,
        (_stage_draws(jf, jm, 120, key), lw), torch.float64)
    np.testing.assert_allclose(topt.numpy(), np.asarray(jopt), rtol=RTOL)
    close_dicts(got, want, RTOL, 'stage')
    assert got_log == want_log


def test_fit_and_report_divergence_path_matches_jax():
    """A stage whose parameters turn NaN (the +1.4 stage of chivi_expts
    on the card) reports mean_err = nan and khat = +inf in both packages,
    through the bound pass and PSIS, and raises nothing."""
    data = jmodels.data_generator_linear(20, 3, seed=5080)
    jm = jmodels.robust_regression_model(data['X'], data['Y'])
    tm = tmodels.robust_regression_model(data['X'], data['Y'])
    jf = vt.mean_field_t_variational_family(3, 4.5)
    tf = pt.mean_field_t_variational_family(3, 4.5)
    init = np.concatenate([np.zeros(3), np.full(3, np.nan)])
    key = jax.random.PRNGKey(2)
    truth = dict(mean=np.zeros(3))
    _, want = quiet(j_ce._fit_and_report, 'bad', vt.black_box_chivi(
        2, jf, jm.log_prob, 500), init, 30, .01, None, jf, jm, truth, 3000,
        key)[0]
    _, got = quiet(t_ce._fit_and_report, 'bad', pt.black_box_chivi(
        2, tf, tm, 500, presampled=True), init, 30, .01, None, tf, tm, truth,
        3000, torch.Generator().manual_seed(2), torch.float64)[0]
    assert np.isnan(want['mean_err']) and np.isnan(got['mean_err'])
    assert want['khat'] == got['khat'] == np.inf


def _jax_protocol(monkeypatch, args, kw, truth):
    """The JAX example's run_protocol with the given truth in place of its
    HMC run; returns its results, its stage log-weights in order and
    what it printed."""
    lws = []

    def fake_hmc(model, key=None, **kwargs):
        return dict(mean=truth['mean'],
                    diagnostics=dict(r_hat=np.ones(model.dim)))

    def recording_lw(*a, **k):
        out = j_lw(*a, **k)
        lws.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(j_ce, 'hmc_ground_truth', fake_hmc)
    monkeypatch.setattr(j_ce, 'get_samples_and_log_weights', recording_lw)
    out, log = quiet(j_ce.run_protocol, *args, jax.random.PRNGKey(0), **kw)
    return out, lws, log


@pytest.mark.parametrize('neff', [False, True])
def test_run_protocol_with_given_truth_matches_jax(monkeypatch, neff):
    """N 20, k 3: the KLVI stage and CHIVI stages (the chivi_expts pair
    +0.1 / +1.4, or the ESS-damped stage) on the JAX example's draws and
    log-weights, against the JAX protocol given the same truth."""
    N, k, n_klvi, mc = 20, 3, 150, 3000
    cfgs = ([('chivi_neff mf-t(8) +1.2', 8, 1.2, 60, .004, .0001)] if neff
            else [('chivi mf-t(4.5) +0.1', 4.5, 0.1, 80, .01, None),
                  ('chivi mf-t(4.5) +1.4 (bad)', 4.5, 1.4, 80, .01, None)])
    truth = dict(mean=np.array([0.5, -0.4, 0.9]))
    args = ('tiny', N, k, 0.05, cfgs, n_klvi, mc, 10)
    want, lws, want_log = _jax_protocol(monkeypatch, args,
                                        dict(use_neff=neff), truth)
    data = jmodels.data_generator_linear(N, k, alpha=1.0,
                                         noise_variance=0.25, rho=0.05,
                                         seed=5080)
    jm = jmodels.robust_regression_model(data['X'], data['Y'], df=40.0)
    seed_key = jax.random.PRNGKey(0)

    def stage_keys(j):
        key = jax.random.fold_in(seed_key, j)
        if j == 1:
            return (_stage_draws(vt.mean_field_t_variational_family(k, 10),
                                 jm, n_klvi, key), lws[0])
        _, df, _, n_it, _, _ = cfgs[j - 10]
        return (_stage_draws(vt.mean_field_t_variational_family(k, df), jm,
                             n_it, key, chivi=True, neff=neff),
                lws[j - 9])

    got, got_log = quiet(
        t_ce.run_protocol, *args, torch.Generator().manual_seed(0),
        use_neff=neff, truth=truth, stage_keys=stage_keys,
        dtype=torch.float64)
    assert set(got) == set(want)
    for name in want:
        close_dicts(got[name], want[name], RTOL, name)
    # the same lines, but for HMC's, which the given truth replaces
    assert got_log == want_log.replace(
        '  HMC truth: max R-hat = 1.0000\n', '')
