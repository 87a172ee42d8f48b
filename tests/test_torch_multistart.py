"""The port's batched pipelines against viabel_tpu.pipeline at float64.

`validated_vi_multistart` and `validated_vi_sweep` of the JAX package run
on robust regression (d = 2) with presampled KLVI and CHIVI on a
mean-field Student-t(40) family and KLVI on the full-rank Student-t(100)
family (the three configurations of benchmarks/khat_noise.py).  The port's
batch core (`pipeline._batch_core`, the batched optimizer with its step
kernel's plain version, then each run's bound pass and PSIS) takes the
inits and draws the JAX package derives from its key: the perturbation
key and ``fold_in(run_key, k)`` a start, each start's key split into its
optimizer and bound keys; the sweep's one key shared by every rate.
Every output agrees to 1e-8 relative, as tests/test_pipeline.py holds the
JAX package's batches against its single runs (each run is 150 adagrad
iterations, whose rounding differences between the two packages grow
along the run, then PSIS).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import funnel_model as jfunnel
from viabel_tpu.models import robust_regression_model as jrr
from viabel_tpu.optimizers import _perturbed_inits as j_perturbed_inits
from viabel_tpu_torch import interop
from viabel_tpu_torch.models import funnel_model as tfunnel
from viabel_tpu_torch.models import robust_regression_model as trr
from viabel_tpu_torch.ops.gaussian_lw import philox_normal
from viabel_tpu_torch.ops.philox import philox_seed
from viabel_tpu_torch.optimizers import _learning_rates, _perturbed_inits
from viabel_tpu_torch.pipeline import (DivergedRunWarning, _batch_core,
                                       _finalize_batch)
from viabel_tpu_torch.psis import _tail_len

pytestmark = [pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')]

N_ITERS, N_BOUND, K = 150, 4000, 3
RTOL = 1e-8
CONFIGS = {
    # name: (family maker, objective maker, init, lr, lr end)
    'mf_t_klvi': (lambda m: m.mean_field_t_variational_family(2, 40),
                  lambda m, f, lp: m.black_box_klvi(f, lp, 20,
                                                    presampled=True),
                  [0.0, 0.0, 1.0, 1.0], 0.05, None),
    'mf_t_chivi': (lambda m: m.mean_field_t_variational_family(2, 40),
                   lambda m, f, lp: m.black_box_chivi(2, f, lp, 40,
                                                      presampled=True),
                   [-2.5, 1.5, 0.5, 0.5], 0.01, None),
    'full_rank_t_klvi': (lambda m: m.t_variational_family(2, 100),
                         lambda m, f, lp: m.black_box_klvi(f, lp, 20,
                                                           presampled=True),
                         [0.0] * 5, 0.1, 0.01),
}
OUT_KEYS = ('opt_param', 'value_history', 'log_norm_history', 'q_mean',
            'q_cov', 'log_weights', 'smoothed_log_weights', 'psis_mean',
            'psis_cov')


def _setup(name):
    make_fam, make_obj, init, lr, lr_end = CONFIGS[name]
    jf, tf = make_fam(vt), make_fam(pt)
    jm, tm = jrr(), trr()
    return (jf, tf, jm, tm, make_obj(vt, jf, jm.log_prob),
            make_obj(pt, tf, tm), np.asarray(init), lr, lr_end)


def _host(draws):
    return jax.tree.map(np.asarray, draws)


def _port_batch(tobj, tf, tm, lr_tables, inits, opt_draws, bound_draws):
    out = _batch_core(tobj, None, tf, tm, N_ITERS, 10, lr_tables, 0.1, 2.0,
                      _tail_len(N_BOUND, 1.0), inits,
                      interop.run_draws(opt_draws),
                      interop.run_draws(bound_draws, presampled=False))
    return _finalize_batch(out, N_BOUND, 2.0, None)


def _compare(got, want):
    for key in OUT_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=1e-10, err_msg=key)
    np.testing.assert_allclose(got['khat'], want['khat'], rtol=RTOL)
    for b_got, b_want in zip(got['bounds'], want['bounds']):
        assert set(b_got) == set(b_want)
        for k in b_want:
            np.testing.assert_allclose(b_got[k], b_want[k], rtol=RTOL,
                                       err_msg=k)
    assert got['best'] == want['best']


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def multistart(request):
    jf, tf, jm, tm, jobj, tobj, init, lr, lr_end = _setup(request.param)
    key = jax.random.PRNGKey(7)
    want = vt.validated_vi_multistart(
        jm.log_prob, jf, jnp.asarray(init), N_ITERS, n_starts=K,
        objective_and_grad=jobj, n_bound_samples=N_BOUND, key=key,
        learning_rate=lr, learning_rate_end=lr_end)
    perturb_key, run_key = jax.random.split(key)
    inits = j_perturbed_inits(jnp.asarray(init), K, 0.5, perturb_key)
    opt, bound = [], []
    for k in range(K):
        opt_key, draw_key = jax.random.split(jax.random.fold_in(run_key, k))
        opt.append(jobj.make_draws(opt_key, N_ITERS, jnp.float64))
        bound.append(jf.base_sample(draw_key, N_BOUND, jnp.float64))
    stack = lambda blocks: _host(jax.tree.map(lambda *v: jnp.stack(v),
                                              *blocks))
    lr_tables = _learning_rates(N_ITERS, lr, lr_end,
                                torch.float64).repeat(K, 1)
    got = _port_batch(tobj, tf, tm, lr_tables,
                      torch.tensor(np.asarray(inits)), stack(opt),
                      stack(bound))
    return request.param, got, want


@pytest.mark.parametrize('key', OUT_KEYS)
def test_multistart_matches_jax(multistart, key):
    _, got, want = multistart
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=RTOL, atol=1e-10, err_msg=key)


def test_multistart_bounds_khat_and_best_match_jax(multistart):
    name, got, want = multistart
    _compare(got, want)
    assert len(got['bounds']) == K and len(got['khat']) == K
    if name == 'mf_t_chivi':  # the log-norm rescaling is on
        assert np.all(np.asarray(want['log_norm_history']) != 0)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_sweep_matches_jax(name):
    """Common random numbers: one key's draws for every rate; the
    learning-rate tables are each rate's schedule, rounded once."""
    jf, tf, jm, tm, jobj, tobj, init, _, _ = _setup(name)
    lrs = [0.003, 0.01, 0.05]
    ends = [lr / 10 for lr in lrs] if name != 'mf_t_klvi' else None
    key = jax.random.PRNGKey(9)
    want = vt.validated_vi_sweep(
        jm.log_prob, jf, jnp.asarray(init), N_ITERS, learning_rates=lrs,
        learning_rate_ends=ends, objective_and_grad=jobj,
        n_bound_samples=N_BOUND, key=key)
    opt_key, draw_key = jax.random.split(key)
    opt = _host(jobj.make_draws(opt_key, N_ITERS, jnp.float64))
    bound = _host(jf.base_sample(draw_key, N_BOUND, jnp.float64))
    tile = lambda block: jax.tree.map(
        lambda v: np.broadcast_to(v, (len(lrs),) + v.shape), block)
    lr_tables = torch.stack([
        _learning_rates(N_ITERS, lr, None if ends is None else ends[k],
                        torch.float64) for k, lr in enumerate(lrs)])
    got = _port_batch(tobj, tf, tm, lr_tables,
                      torch.as_tensor(init).repeat(len(lrs), 1), tile(opt),
                      tile(bound))
    _compare(got, want)
    np.testing.assert_array_equal(want['learning_rates'], lrs)


def test_multistart_public_path_is_validated_vi_of_each_start():
    """Start k of the public entry point is `validated_vi` from start k's
    init with the generator seeded as the multistart seeds it: a seed for
    the perturbation noise first, then one a start.  The batched
    optimizer's vmapped gradient equals the single run's to 1e-12."""
    tm = trr()
    fam = pt.mean_field_t_variational_family(2, 40)
    init = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    kw = dict(n_mc_samples=10, n_bound_samples=2000, learning_rate=0.05,
              device='cpu')
    out = pt.validated_vi_multistart(
        tm, fam, init, 80, n_starts=3, perturb_scale=0.3,
        generator=torch.Generator().manual_seed(11), **kw)
    g = torch.Generator().manual_seed(11)
    noise = philox_normal(3, 4, philox_seed(g), dtype=torch.float64,
                          device='cpu')
    inits = _perturbed_inits(init, 3, 0.3, noise)
    assert torch.equal(inits[0], init)
    for k in range(3):
        single = pt.validated_vi(
            tm, fam, inits[k], 80,
            generator=torch.Generator().manual_seed(philox_seed(g)), **kw)
        torch.testing.assert_close(out['opt_param'][k], single['opt_param'],
                                   rtol=1e-12, atol=1e-14)
        assert out['khat'][k] == pytest.approx(single['khat'], rel=1e-10)
        assert out['bounds'][k]['d2'] == pytest.approx(
            single['bounds']['d2'], rel=1e-10)
    d2 = [b['d2'] for b in out['bounds']]
    assert out['best'] == int(np.argmin(d2))


def test_multistart_init_params_and_sweep_public_path():
    tm = trr()
    fam = pt.t_variational_family(2, 100)
    inits = torch.zeros(2, 5, dtype=torch.float64)
    inits[1, :2] = torch.tensor([-2.0, 1.0], dtype=torch.float64)
    kw = dict(n_mc_samples=10, n_bound_samples=2000, device='cpu')
    out = pt.validated_vi_multistart(tm, fam, inits[0], 60,
                                     init_params=inits, learning_rate=0.05,
                                     **kw)
    assert out['opt_param'].shape == (2, 5) and len(out['khat']) == 2
    assert out['value_history'].shape == (2, 60)
    # the sweep: rate k is validated_vi at that rate on the same generator
    sweep = pt.validated_vi_sweep(
        tm, fam, inits[0], 60, learning_rates=[0.01, 0.1],
        generator=torch.Generator().manual_seed(4), **kw)
    for k, lr in enumerate([0.01, 0.1]):
        single = pt.validated_vi(
            tm, fam, inits[0], 60, learning_rate=lr,
            generator=torch.Generator().manual_seed(4), **kw)
        torch.testing.assert_close(sweep['opt_param'][k],
                                   single['opt_param'], rtol=1e-12,
                                   atol=1e-14)
    np.testing.assert_array_equal(sweep['learning_rates'], [0.01, 0.1])


def test_multistart_with_a_generator_sampling_objective():
    """An objective that draws from a generator (no presampling) runs each
    start in turn with its own generator, as `validated_vi` would."""
    tm = trr()
    fam = pt.mean_field_t_variational_family(2, 40)
    obj = pt.perturbed_black_box_vi(fam, tm, 10)
    init = torch.zeros(4, dtype=torch.float64)
    out = pt.validated_vi_multistart(
        tm, fam, init, 40, n_starts=2, objective_and_grad=obj,
        n_bound_samples=1000, generator=torch.Generator().manual_seed(3),
        device='cpu')
    assert all(np.isfinite(k) for k in out['khat'])
    sweep = pt.validated_vi_sweep(
        tm, fam, init, 40, learning_rates=[0.02, 0.02],
        objective_and_grad=obj, n_bound_samples=1000, device='cpu')
    assert torch.equal(sweep['opt_param'][0], sweep['opt_param'][1])


def test_multistart_all_diverged_warns_once():
    """A batch warns only when every run diverged (then `best` falls back
    to 0); a healthy batch does not warn (tests/test_pipeline.py:660-683)."""
    model = tfunnel()
    fam = pt.mean_field_gaussian_variational_family(2)
    init = torch.zeros(4, dtype=torch.float64)
    kw = dict(n_starts=2, n_bound_samples=4000, device='cpu',
              generator=torch.Generator().manual_seed(0))
    with pytest.warns(DivergedRunWarning, match='every run') as record:
        out = pt.validated_vi_multistart(model, fam, init, 200,
                                         learning_rate=1e18, **kw)
    assert sum(issubclass(w.category, DivergedRunWarning)
               for w in record) == 1
    assert all(not np.isfinite(k) for k in out['khat'])
    assert out['best'] == 0
    with warnings.catch_warnings():
        warnings.simplefilter('error', DivergedRunWarning)
        kw['generator'] = torch.Generator().manual_seed(0)
        pt.validated_vi_multistart(model, fam, init, 200,
                                   learning_rate=.05, **kw)


def test_best_skips_diverged_runs_and_ties_to_the_lowest_index():
    out = {'stats': torch.tensor([[np.nan] * 5, [0.5, 0.3, 0.2, 0.4, 0.1],
                                  [0.5, 0.3, 0.2, 0.4, 0.1]],
                                 dtype=torch.float64),
           'moments': torch.ones(3, 2, dtype=torch.float64),
           'khat': torch.tensor([np.nan, 0.3, 0.3], dtype=torch.float64),
           'q_cov': torch.eye(2, dtype=torch.float64).repeat(3, 1, 1)}
    with warnings.catch_warnings():
        warnings.simplefilter('error', DivergedRunWarning)
        got = _finalize_batch(out, 1000, 2.0, None)
    assert got['best'] == 1 and not np.isfinite(got['bounds'][0]['d2'])


def test_sweep_validates_inputs():
    model = tfunnel()
    fam = pt.mean_field_gaussian_variational_family(2)
    init = torch.zeros(4, dtype=torch.float64)
    for bad, match in ((dict(learning_rates=[0.01, -0.1]), 'positive'),
                       (dict(learning_rates=[0.01],
                             learning_rate_ends=[0.02]), 'end rate'),
                       (dict(learning_rates=[0.01],
                             learning_rate_ends=[0.0]), 'end rate'),
                       (dict(learning_rates=[0.01, 0.02],
                             learning_rate_ends=[0.001]), 'match'),
                       (dict(learning_rates=[]), 'non-empty')):
        with pytest.raises(ValueError, match=match):
            pt.validated_vi_sweep(model, fam, init, 100, device='cpu', **bad)
    # a mesh without the run axis is refused (the batches on a mesh are
    # held in tests/test_torch_parallel.py)
    from viabel_tpu_torch import parallel
    sample_only = parallel.make_mesh(('sample',), devices=['cpu'] * 2)
    for fn, kw in ((pt.validated_vi_sweep, dict(learning_rates=[0.01])),
                   (pt.validated_vi_multistart, {})):
        with pytest.raises(ValueError, match="axis named 'chain'"):
            fn(model, fam, init, 10, mesh=sample_only, device='cpu', **kw)


@pytest.mark.parametrize('family_name', ['mf_gaussian', 'mf_t',
                                         'full_rank_gaussian',
                                         'full_rank_t'])
def test_validated_vi_all_families(family_name):
    """The single-run pipeline takes every family, the full-rank ones by
    the plain transform and density with K3's statistics
    (tests/test_pipeline.py:337-355), and agrees with the JAX package's on
    its derived draws."""
    make = dict(
        mf_gaussian=lambda m: m.mean_field_gaussian_variational_family(2),
        mf_t=lambda m: m.mean_field_t_variational_family(2, 40),
        full_rank_gaussian=lambda m: m.full_rank_gaussian_variational_family(
            2),
        full_rank_t=lambda m: m.t_variational_family(2, 40))[family_name]
    jf, tf = make(vt), make(pt)
    jm, tm = jfunnel(), tfunnel()
    jobj = vt.black_box_klvi(jf, jm.log_prob, 20, presampled=True)
    tobj = pt.black_box_klvi(tf, tm, 20, presampled=True)
    key = jax.random.PRNGKey(4)
    want = vt.validated_vi(jm.log_prob, jf, jf.init_param(jnp.float64), 300,
                           objective_and_grad=jobj, n_bound_samples=5000,
                           key=key)
    assert np.isfinite(want['bounds']['d2'])
    opt_key, draw_key = jax.random.split(key)
    from viabel_tpu_torch.optimizers import _wrap_objective
    from viabel_tpu_torch.pipeline import _pipeline_core
    got = _pipeline_core(
        _wrap_objective(tobj, None), tf, tm, 300, 10, 0.01, 0.1, None, 2.0,
        _tail_len(5000, 1.0), tf.init_param(torch.float64),
        interop.presampled_draws(_host(jobj.make_draws(opt_key, 300,
                                                       jnp.float64))),
        interop.base_draws(_host(jf.base_sample(draw_key, 5000,
                                                jnp.float64))))
    for key_ in ('opt_param', 'log_weights', 'psis_mean', 'q_cov'):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   rtol=RTOL, atol=1e-10, err_msg=key_)
    out = pt.validated_vi(tm, tf, tf.init_param(torch.float64), 300,
                          n_mc_samples=20, n_bound_samples=5000,
                          device='cpu')
    assert np.isfinite(out['bounds']['d2'])
    assert np.isfinite(out['khat']) or out['khat'] == np.inf
    assert out['psis_mean'].shape == (2,)
