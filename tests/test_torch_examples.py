"""The port's example layer (`viabel_tpu_torch.examples`) against the JAX
package's examples (examples/*.py), float64 on the CPU, on shared inputs
at rtol 1e-10: the normal mixture's bound configurations on the JAX
example's samples, and the helpers (`bounds_and_khat` fed the log-weights
that the JAX package's `get_samples_and_log_weights` draws with the key,
`_cov_distance`, `_l2`, `_block_errors`).  The robust-regression fits and
the CHIVI protocols have files of their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import models as jmodels
from viabel_tpu.experiments import get_samples_and_log_weights as j_lw
from viabel_tpu_torch import interop
from viabel_tpu_torch import models as tmodels

from examples import eight_schools_ia as j_esia
from examples import linear_regression_ia as j_lria
from examples import normal_mixture as j_nm
from examples import robust_regression as j_rr
from viabel_tpu_torch.examples import eight_schools_ia as t_esia
from viabel_tpu_torch.examples import linear_regression_ia as t_lria
from viabel_tpu_torch.examples import normal_mixture as t_nm
from viabel_tpu_torch.examples import robust_regression as t_rr
from torch_examples_helpers import close_dicts, one_thread, quiet  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning',
    'ignore::viabel_tpu.bounds.MonteCarloErrorWarning')

RTOL = 1e-10


# ---------------------------------------------------------------- the mixture

def test_normal_mixture_four_configurations_match_jax():
    """The JAX example under x64 draws 5e4 f64 samples from PRNGKey(918);
    the port's main is given the same samples."""
    samples = np.sqrt(5.0) * np.asarray(
        jax.random.normal(jax.random.PRNGKey(918), (50000,)))
    want, want_log = quiet(j_nm.main)
    got, got_log = quiet(t_nm.main, device='cpu', samples=samples)
    assert set(got) == set(want)
    for name in want:
        close_dicts(got[name], want[name], RTOL, name)
    assert got_log.count('2-Wasserstein') == want_log.count('2-Wasserstein')
    np.testing.assert_allclose(got['analytic_mb_ref_input']['W2'], 2.72,
                               rtol=0.02)


# -------------------------------------------------------- robust regression

def _robust(kind):
    jm, tm = jmodels.robust_regression_model(), \
        tmodels.robust_regression_model()
    if kind == 'mf':
        return jm, tm, vt.mean_field_t_variational_family(2, 40), \
            pt.mean_field_t_variational_family(2, 40)
    return jm, tm, vt.t_variational_family(2, 100), \
        pt.t_variational_family(2, 100)


@pytest.mark.parametrize('kind,elbo', [('mf', None), ('mf', -60.0),
                                       ('full', None)])
def test_bounds_and_khat_matches_jax(kind, elbo):
    jm, tm, jf, tf = _robust(kind)
    rng = np.random.default_rng(5)
    param = np.concatenate([[-2.5, 1.5], rng.normal(-0.5, 0.1,
                                                    jf.var_param_dim - 2)])
    key = jax.random.PRNGKey(11)
    want = j_rr.bounds_and_khat(jm, jf, jnp.asarray(param), 20000, key,
                                elbo=elbo)
    lw = np.asarray(j_lw(jm.log_prob, jf, jnp.asarray(param), 20000, key)[1])
    got = t_rr.bounds_and_khat(tm, tf, interop.var_param(param), 20000, lw,
                               elbo=elbo)
    close_dicts(got[0], want[0], RTOL, 'bounds')
    np.testing.assert_allclose(got[1:], want[1:], rtol=RTOL)


# ------------------------------------------------------------- IA helpers

def test_cov_distance_matches_jax():
    jf = vt.t_variational_family(4, df=1000000)
    tf = pt.t_variational_family(4, df=1000000)
    rng = np.random.default_rng(1)
    params = rng.normal(0, 0.3, (30, jf.var_param_dim))
    true_cov = np.cov(rng.normal(size=(4, 40)))
    np.testing.assert_allclose(
        t_lria._cov_distance(tf, params, true_cov),
        j_lria._cov_distance(jf, params, true_cov), rtol=RTOL)


@pytest.mark.parametrize('shape', [(40, 10), (40,), (1, 3)])
def test_l2_and_block_errors_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    raw = rng.normal(size=shape)
    ia = rng.normal(size=shape)
    truth = rng.normal(size=shape[1:])
    np.testing.assert_allclose(t_esia._l2(raw - truth),
                               j_esia._l2(raw - truth), rtol=RTOL)
    want, want_log = quiet(j_esia._block_errors, 'block', raw, ia, truth)
    got, got_log = quiet(t_esia._block_errors, 'block', raw, ia, truth)
    assert got == want and got_log == want_log
