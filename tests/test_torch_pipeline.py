"""The port's validated-VI pipeline against viabel_tpu.pipeline, float64.

The whole `_pipeline_core` runs on the exact draws the JAX package's
`_pipeline_core` derives from its key split (optimizer draws from the
first key, bound-pass base draws from the second), at a small size, and
every output is compared.  The DivergedRunWarning semantics follow the
JAX package: non-finite log-weight statistics warn, a short-tail khat of
+inf does not.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import eight_schools_cp_model as jcp
from viabel_tpu.optimizers import _wrap_objective as j_wrap
from viabel_tpu.pipeline import _assemble_bounds as j_assemble
from viabel_tpu.pipeline import _pipeline_core as j_core
from viabel_tpu_torch import interop
from viabel_tpu_torch.models import eight_schools_cp_model as tcp
from viabel_tpu_torch.optimizers import _wrap_objective as t_wrap
from viabel_tpu_torch.pipeline import DivergedRunWarning
from viabel_tpu_torch.pipeline import _assemble_bounds as t_assemble
from viabel_tpu_torch.pipeline import _pipeline_core as t_core
from viabel_tpu_torch.psis import _tail_len

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

N_ITERS, N_MC, N_BOUND = 200, 20, 20000
KW = dict(window=10, learning_rate=0.01, epsilon=0.1,
          learning_rate_end=0.001, alpha=2.0)


@pytest.fixture(scope='module')
def runs():
    jm, tm = jcp(), tcp()
    jf = vt.mean_field_t_variational_family(10, 40)
    tf = pt.mean_field_t_variational_family(10, 40)
    jobj = vt.black_box_klvi(jf, jm.log_prob, N_MC, presampled=True)
    tobj = pt.black_box_klvi(tf, tm, N_MC, presampled=True)
    key = jax.random.PRNGKey(3)
    tail_len = _tail_len(N_BOUND, 1.0)
    jout = j_core(j_wrap(jobj, None), jf, jm.log_prob, N_ITERS, N_BOUND,
                  KW['window'], KW['learning_rate'], KW['epsilon'],
                  KW['learning_rate_end'], KW['alpha'], 1, tail_len,
                  jnp.zeros(20, jnp.float64), key)
    opt_key, draw_key = jax.random.split(key)
    draws = interop.presampled_draws(
        jobj.make_draws(opt_key, N_ITERS, jnp.float64))
    z = interop.base_draws(jf.base_sample(draw_key, N_BOUND, jnp.float64))

    def port(model):
        return t_core(t_wrap(tobj, None), tf, model, N_ITERS, KW['window'],
                      KW['learning_rate'], KW['epsilon'],
                      KW['learning_rate_end'], KW['alpha'], tail_len,
                      torch.zeros(20, dtype=torch.float64), draws, z)

    # the kernel-tagged model (fused K1 path, plain versions on the CPU)
    # and an untagged callable (plain composition + log-weight kernels)
    return jout, port(tm), port(lambda x: tm.log_prob(x))


@pytest.mark.parametrize('key', [
    'opt_param', 'value_history', 'log_norm_history', 'q_mean', 'q_cov',
    'log_weights', 'smoothed_log_weights', 'khat', 'psis_mean', 'psis_cov'])
def test_pipeline_core_matches_jax(runs, key):
    jout, tout, _ = runs
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                               rtol=1e-9, atol=1e-12)


def test_pipeline_statistics_and_bounds_match_jax(runs):
    jout, tout, _ = runs
    pack = np.asarray(jout['host_pack'])
    np.testing.assert_allclose(tout['stats'].numpy(), pack[:5], rtol=1e-10)
    np.testing.assert_allclose(tout['moments'].numpy(), pack[5:7],
                               rtol=1e-10)
    j_bounds, j_khat, j_div = j_assemble(jout['host_pack'], N_BOUND, 10, 2.0,
                                         None)
    t_bounds, t_khat, t_div = t_assemble(
        tout['stats'], tout['moments'], tout['khat'], tout['q_cov'],
        N_BOUND, 2.0, None)
    assert not t_div and not j_div
    assert set(t_bounds) == set(j_bounds)
    for k in j_bounds:
        np.testing.assert_allclose(t_bounds[k], j_bounds[k], rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(t_khat, j_khat, rtol=1e-9)


def test_kernel_path_equals_plain_composition(runs):
    _, tagged, untagged = runs
    for key in ('opt_param', 'log_weights', 'stats', 'khat', 'psis_mean'):
        np.testing.assert_allclose(tagged[key].numpy(),
                                   untagged[key].numpy(), rtol=1e-12,
                                   atol=1e-12)


def _small_run(init, n_bound=4000, **kw):
    model = tcp()
    fam = pt.mean_field_t_variational_family(10, 40)
    return pt.validated_vi(model, fam, init, 100, n_mc_samples=10,
                           n_bound_samples=n_bound, device='cpu', **kw)


def test_validated_vi_public_path_is_healthy_and_seeded():
    init = torch.zeros(20, dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter('error', DivergedRunWarning)
        out = _small_run(init, learning_rate=0.05)
    again = _small_run(init, learning_rate=0.05)
    assert torch.equal(out['opt_param'], again['opt_param'])
    assert np.isfinite(out['bounds']['d2']) and np.isfinite(out['khat'])
    assert set(out['bounds']) == {'W1', 'W2', 'mean_error', 'std_error',
                                  'cov_error', 'd2', 'log_norm_bound'}
    assert out['psis_cov'].shape == (10, 10)


def test_nan_init_warns_diverged():
    init = torch.full((20,), float('nan'), dtype=torch.float64)
    with pytest.warns(DivergedRunWarning, match='diverged'):
        out = _small_run(init)
    assert not np.isfinite(out['khat'])
    assert not np.isfinite(out['bounds']['d2'])


def test_short_tail_khat_inf_does_not_warn_diverged():
    init = torch.zeros(20, dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter('error', DivergedRunWarning)
        out = _small_run(init, n_bound=16, learning_rate=0.05)
    assert np.isinf(out['khat'])


def test_low_df_family_uses_empirical_moments_and_alpha_3():
    from viabel_tpu_torch.pipeline import _closed_form_moments
    model = tcp()
    fam = pt.mean_field_t_variational_family(10, 3)
    init = torch.zeros(20, dtype=torch.float64)
    assert _closed_form_moments(fam, init, 2.0) is None
    out = pt.validated_vi(model, fam, init, 50, n_mc_samples=10,
                          n_bound_samples=4000, device='cpu')
    assert np.isfinite(out['bounds']['d2'])
    assert not np.isnan(out['bounds']['W2'])  # empirical C4 is finite
    out3 = pt.validated_vi(model, fam, init, 50, n_mc_samples=10,
                           n_bound_samples=4000, alpha=3.0, device='cpu')
    assert set(out3['bounds']) == {'dalpha', 'log_norm_bound'}


def test_mesh_is_not_ported():
    """The mesh is ported now (tests/test_torch_parallel.py holds it to
    the unsharded run): a mesh of the sample axis runs and places the
    log-weights on it, and a mesh without that axis is refused."""
    from viabel_tpu_torch import parallel
    fam = pt.mean_field_t_variational_family(10, 40)
    out = pt.validated_vi(tcp(), fam, torch.zeros(20), 10,
                          n_bound_samples=2000, device='cpu',
                          mesh=parallel.make_mesh(('sample',),
                                                  devices=['cpu'] * 2))
    assert isinstance(out['log_weights'], parallel.Sharded)
    assert parallel.fetch_global(out['log_weights']).shape == (2000,)
    with pytest.raises(ValueError, match="axis named 'sample'"):
        pt.validated_vi(tcp(), fam, torch.zeros(20), 10, device='cpu',
                        mesh=parallel.make_mesh(('chain',),
                                                devices=['cpu'] * 2))


def test_get_samples_and_log_weights_on_cpu():
    model = tcp()
    fam = pt.mean_field_gaussian_variational_family(10)
    vp = torch.as_tensor(np.concatenate(
        [model.true_mean, 0.5 * np.log(np.diag(model.true_cov))]))
    samples, lw = pt.get_samples_and_log_weights(
        model, fam, vp, 5000, generator=torch.Generator().manual_seed(1),
        device='cpu')
    assert samples.shape == (5000, 10) and lw.shape == (5000,)
    np.testing.assert_allclose(
        lw.numpy(),
        (model.log_prob(samples) - fam.log_prob(vp, samples)).numpy(),
        rtol=1e-12, atol=1e-12)
