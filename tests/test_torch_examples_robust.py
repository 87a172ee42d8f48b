"""The port's robust-regression example against
examples/robust_regression.py, float64 on the CPU, on shared draws:
`timed_optimize` fed the presampled block of the JAX run's key
(`make_draws`, the draws of its key-threaded run) at rtol 1e-10, and the
notebook's three fits (KLVI mf-t(40), CHIVI warm-started at +3.0,
full-rank t(100) KLVI, each with its bound pass) fed each stage's draws
and log-weights at rtol 1e-8 (the `run_experiment` test's rule).  The JAX
reference's adagrad runs with ``unroll=1`` (a compile-time knob that
changes no bit) to keep its compile short.
"""

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

from examples import robust_regression as j_rr
from viabel_tpu_torch.examples import robust_regression as t_rr
from torch_examples_helpers import close_dicts, one_thread, quiet  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning',
    'ignore::viabel_tpu.bounds.MonteCarloErrorWarning')

RTOL, FIT_RTOL = 1e-10, 1e-8


def test_timed_optimize_matches_jax_on_its_draws():
    jm, tm = jmodels.robust_regression_model(), \
        tmodels.robust_regression_model()
    jf = vt.mean_field_t_variational_family(2, 40)
    tf = pt.mean_field_t_variational_family(2, 40)
    jobj = vt.black_box_klvi(jf, jm.log_prob, 100)
    key = jax.random.PRNGKey(4)
    init = np.array([0.0, 0.0, 1.0, 1.0])
    want, _ = j_rr.timed_optimize(150, jobj, jnp.asarray(init), key,
                                  learning_rate=.01, unroll=1)
    draws = vt.black_box_klvi(jf, jm.log_prob, 100, presampled=True) \
        .make_draws(key, 150, jnp.float64)
    got, it_s = t_rr.timed_optimize(
        150, pt.black_box_klvi(tf, tm, 100, presampled=True),
        torch.as_tensor(init), interop.presampled_draws(draws), 'cpu',
        learning_rate=.01)
    assert it_s > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-13)


def test_robust_regression_three_fits_match_jax():
    """The JAX example's body at float64 (its helpers, its six keys, its
    non-presampled objectives) against the port's main fed each stage's
    draws and log-weights."""
    n_iters, mc = 200, 20000
    jm = jmodels.robust_regression_model()
    k1, k2, k3, k4, k5, k6 = jax.random.split(jax.random.PRNGKey(0), 6)
    fam = vt.mean_field_t_variational_family(2, 40)
    tfam = vt.t_variational_family(2, 100)

    def fit(obj, pobj, init, key, **kw):
        (param, _, _, _), _ = j_rr.timed_optimize(n_iters, obj, init, key,
                                                  unroll=1, **kw)
        return param, interop.presampled_draws(pobj.make_draws(
            key, n_iters, jnp.float64))

    def lws(f, param, key):
        return np.asarray(j_lw(jm.log_prob, f, param, mc, key)[1])

    klvi_p, d1 = fit(vt.black_box_klvi(fam, jm.log_prob, 100),
                     vt.black_box_klvi(fam, jm.log_prob, 100,
                                       presampled=True),
                     jnp.array([0.0, 0.0, 1.0, 1.0]), k1, learning_rate=.01)
    _, khat_klvi, elbo = j_rr.bounds_and_khat(jm, fam, klvi_p, mc, k2)
    chivi_p, d3 = fit(vt.black_box_chivi(2, fam, jm.log_prob, 500),
                      vt.black_box_chivi(2, fam, jm.log_prob, 500,
                                         presampled=True),
                      klvi_p.at[2:].add(3.0), k3, learning_rate=.01)
    _, khat_chivi, _ = j_rr.bounds_and_khat(jm, fam, chivi_p, mc, k4,
                                            elbo=elbo)
    full_p, d5 = fit(vt.black_box_klvi(tfam, jm.log_prob, 100),
                     vt.black_box_klvi(tfam, jm.log_prob, 100,
                                       presampled=True),
                     tfam.init_param(jnp.float64), k5, learning_rate=.1,
                     learning_rate_end=.001)
    res, khat_full, _ = j_rr.bounds_and_khat(jm, tfam, full_p, mc, k6)
    want = dict(khat_full=khat_full, W2_full=res['W2'], d2_full=res['d2'],
                mean_err_full=res['mean_error'], khat_klvi=khat_klvi,
                khat_chivi=khat_chivi)
    sources = [d1, lws(fam, klvi_p, k2), d3, lws(fam, chivi_p, k4), d5,
               lws(tfam, full_p, k6)]
    got, log = quiet(t_rr.main, n_iters=n_iters, mc_samples=mc,
                      device='cpu', dtype=torch.float64, key=sources)
    close_dicts(got, want, FIT_RTOL, 'robust regression')
    for line in ('KLVI mf-t(40):', 'CHIVI:', 'full-rank KLVI:',
                 'khat = ', '2-Wasserstein'):
        assert line in log
