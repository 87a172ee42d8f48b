"""The port's iterate-averaging optimizers against viabel_tpu.optimizers,
float64, and the whole regression slice against the JAX package.

The chains run on shared draws: each chain's presampled block is the JAX
package's ``make_draws_range(chain_key, 0, n_iters)`` and the init noise
its ``normal(init_key, (n_chains, P))``, so the trajectories (values,
pre-update history, final and averaged parameters) compare at rtol 1e-10.
The R-hat post-pass runs on one history in both packages and must give
the same start iterations and averages.  The slice test then carries the
averaged fit through the bound pass and PSIS on the same Philox draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import optimizers as jo
from viabel_tpu.experiments import check_accuracy as j_check_accuracy
from viabel_tpu.models import regression as jr
from viabel_tpu.psis import psislw as j_psislw
from viabel_tpu.psis import weighted_moments as j_weighted_moments
from viabel_tpu_torch import interop
from viabel_tpu_torch import optimizers as to
from viabel_tpu_torch.models import regression as tr
from viabel_tpu_torch.ops.gaussian_lw import gaussian_sample_score_partials
from viabel_tpu_torch.ops.philox import philox_normal_plain

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

RTOL = 1e-10
D, N_MC, N_ITERS, N_CHAINS = 10, 20, 300, 3


def _models(N=100):
    data = jr.data_generator_linear(N=N, D=D, alpha=1.0, noise_variance=0.25,
                                    rho=0.5, seed=42)
    return (jr.linear_regression_model(data['X'], data['Y']),
            tr.linear_regression_model(data['X'], data['Y']))


def _run_both(kind, lr=0.02, hist_cap=None, avg_start=None, lr_end=None,
              init=None, seed=0):
    jm, tm = _models()
    jf = vt.mean_field_gaussian_variational_family(D)
    tf = pt.mean_field_gaussian_variational_family(D)
    jobj = vt.black_box_klvi(jf, jm.log_prob, N_MC, presampled=True)
    tobj = pt.black_box_klvi(tf, tm, N_MC, presampled=True)
    init = np.zeros(2 * D) if init is None else init
    scale = 0.5 if kind == 'rmsprop' else 0.2
    key = jax.random.PRNGKey(seed)
    init_key, *chain_keys = jax.random.split(key, N_CHAINS + 1)
    jinits = jo._perturbed_inits(jnp.asarray(init), N_CHAINS, scale,
                                 init_key)
    jout = jo._chains_run(jo._wrap_objective(jobj, None), kind, N_ITERS, lr,
                          1e-6, lr_end, jinits, jnp.stack(chain_keys),
                          hist_cap=hist_cap, avg_start=avg_start)
    noise = jax.random.normal(init_key, (N_CHAINS, 2 * D), jnp.float64)
    draws = np.stack([np.asarray(jobj.make_draws_range(k, 0, N_ITERS,
                                                       jnp.float64))
                      for k in chain_keys])
    tinits = to._perturbed_inits(torch.as_tensor(init), N_CHAINS, scale,
                                 torch.as_tensor(np.array(noise)))
    np.testing.assert_allclose(tinits.numpy(), np.asarray(jinits),
                               rtol=1e-14)
    tout = to._chains_run(to._batched_step(tobj, None), kind, N_ITERS, lr,
                          1e-6, lr_end, tinits, interop.chain_draws(draws),
                          hist_cap=hist_cap, avg_start=avg_start)
    return jout, tout


def _assert_runs_match(jout, tout):
    (jv, jl, jc), jfinal, javg = jout
    (tv, tl, tc), tfinal, tavg = tout
    for got, want in ((tv, jv), (tl, jl), (tc, jc), (tfinal, jfinal),
                      (tavg, javg)):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-12)


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
def test_chains_run_matches_jax(kind):
    _assert_runs_match(*_run_both(kind, avg_start=int(N_ITERS // 1.3)))


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
def test_chains_run_ring_buffer_and_schedule_match_jax(kind):
    """A history cap below n_iters (the ring buffer), a decaying learning
    rate, a nonzero init and no online average."""
    init = np.concatenate([np.full(D, 0.3), np.full(D, -0.5)])
    _assert_runs_match(*_run_both(kind, lr=0.05, hist_cap=120, lr_end=0.01,
                                  init=init, seed=3))


def test_history_entries_are_pre_update_parameters():
    """Entry 0 is the init, entry 1 the parameter after one update, and
    the final parameter is one update past the last entry."""
    _, tm = _models()
    tf = pt.mean_field_gaussian_variational_family(D)
    step = to._batched_step(pt.black_box_klvi(tf, tm, N_MC, presampled=True),
                            None)
    inits = torch.as_tensor(np.random.RandomState(0).normal(0, .1,
                                                            (2, 2 * D)))
    draws = torch.as_tensor(np.random.RandomState(1).randn(2, 5, N_MC, D))
    (_, _, chains), final, _ = to._chains_run(step, 'rmsprop', 5, 0.02, 1e-6,
                                              None, inits, draws)
    assert torch.equal(chains[:, 0], inits)
    _, grad, _ = step(inits, draws[:, 0])
    one, _, _ = to._chain_step('rmsprop', 0, 5, 0.02, 1e-6, None, inits,
                               grad, None, None)
    assert torch.equal(chains[:, 1], one)
    assert not torch.equal(chains[:, -1], final)


@pytest.mark.parametrize('rhat_window,tail', [(50, 75), (1000, 75),
                                              (30, 400)])
def test_ia_postprocess_matches_jax(rhat_window, tail):
    jout, tout = _run_both('rmsprop', avg_start=int(N_ITERS // 1.3))
    (jv, jl, jc), _, _ = jout
    (tv, tl, tc), _, _ = tout
    args = (rhat_window, 1.15, 1.20, tail)
    jres = jo._ia_postprocess(D, jc, jv, jl, *args)
    tres = to._ia_postprocess(D, tc.numpy(), tv.numpy(), tl.numpy(), *args)
    jlog, tlog = jres[4], tres[4]
    assert tlog['start_avg_mean_iters'] == jlog['start_avg_mean_iters']
    assert tlog['start_avg_sigma_iters'] == jlog['start_avg_sigma_iters']
    for k in ('r_hat_mean', 'r_hat_sigma', 'r_hat_mean_halfway',
              'r_hat_sigma_halfway'):
        np.testing.assert_allclose(tlog[k], jlog[k], rtol=RTOL)
    for got, want in zip(tres[0] + tres[1], jres[0] + jres[1]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tres[2], np.asarray(jres[2]), rtol=RTOL)


def test_public_optimizers_run_and_refuse_what_is_not_ported():
    _, tm = _models(N=30)
    fam = pt.mean_field_gaussian_variational_family(D)
    obj = pt.black_box_klvi(fam, tm, 10, presampled=True)
    init = torch.zeros(2 * D, dtype=torch.float64)
    kw = dict(learning_rate=0.02, n_optimisers=2, rhat_window=20,
              tail_avg_iters=30, device='cpu')
    outs = [opt(120, obj, init, D, generator=torch.Generator().manual_seed(1),
                **kw)
            for opt in (pt.rmsprop_IA_optimize_with_rhat,
                        pt.rmsprop_IA_optimize_with_rhat,
                        pt.adam_IA_optimize_with_rhat)]
    final, chains, am, asg, values, lns, log = outs[0]
    assert chains.shape == (2, 120, 2 * D) and values.shape == (240,)
    assert len(am) == len(asg) == 2 and final.shape == (2 * D,)
    assert log['averaged_variational_param'].shape == (2, 2 * D)
    np.testing.assert_array_equal(chains[0, 0], np.zeros(2 * D))
    np.testing.assert_array_equal(outs[0][1], outs[1][1])  # deterministic
    assert not np.array_equal(outs[0][1], outs[2][1])
    # chain 0's draws are the Philox rows of its generator's seed
    plain = pt.rmsprop_IA_optimize(60, obj, init, D, learning_rate=0.02,
                                   tail_avg_iters=30, device='cpu')
    assert plain[6]['start_avg_mean_iters'] == 30
    g = torch.Generator().manual_seed(77)
    rows = obj.make_draws_range(g, 5, 3, torch.float64)
    np.testing.assert_array_equal(
        rows.reshape(-1, D).numpy(),
        philox_normal_plain(30, D, 77, 0, 50, torch.float64).numpy())
    assert torch.equal(rows, obj.make_draws_range(g, 0, 8,
                                                  torch.float64)[5:])
    # checkpoints, progress and objectives that sample inside the step
    # are ported (tests/test_torch_segmented.py), and the mesh: its chains
    # split over a chain axis equal the run without one
    # (tests/test_torch_parallel.py), and a mesh without one is refused;
    # a perturbed objective, which draws its own noise, runs too
    from viabel_tpu_torch import parallel
    on_mesh = pt.rmsprop_IA_optimize_with_rhat(
        120, obj, init, D, generator=torch.Generator().manual_seed(1),
        mesh=parallel.make_mesh(('chain',), devices=['cpu'] * 2), **kw)
    np.testing.assert_array_equal(on_mesh[1], outs[0][1])
    with pytest.raises(ValueError, match="axis named 'chain'"):
        pt.rmsprop_IA_optimize_with_rhat(
            10, obj, init, D, mesh=parallel.make_mesh(
                ('sample',), devices=['cpu'] * 2), **kw)
    perturbed = pt.adam_IA_optimize_with_rhat(
        40, pt.perturbed_black_box_vi(fam, tm, 10), init, D, **kw)
    assert perturbed[1].shape == (2, 40, 2 * D)
    assert np.all(np.isfinite(perturbed[1]))
    assert np.all(np.isfinite(perturbed[6]['averaged_variational_param']))


PERTURB = 0.1


def _perturbed_run_both(kind, n_iters=100, n_chains=2, seed=5):
    """The JAX package's key-driven chains of `perturbed_black_box_vi`
    against the port's fed the same noise and base draws: chain c's
    iteration i splits ``fold_in(chain_key_c, i)`` into the noise's key and
    the sample key (viabel_tpu/objectives.py:290-295)."""
    jm, tm = _models()
    jf = vt.mean_field_gaussian_variational_family(D)
    tf = pt.mean_field_gaussian_variational_family(D)
    jobj = vt.perturbed_black_box_vi(jf, jm.log_prob, N_MC,
                                     perturbation_scale=PERTURB)
    tobj = pt.perturbed_black_box_vi(tf, tm, N_MC,
                                     perturbation_scale=PERTURB)
    scale = 0.5 if kind == 'rmsprop' else 0.2
    init_key, *chain_keys = jax.random.split(jax.random.PRNGKey(seed),
                                             n_chains + 1)
    init = jnp.zeros(2 * D, dtype=jnp.float64)
    jinits = jo._perturbed_inits(init, n_chains, scale, init_key)
    args = (kind, n_iters, 0.02, 1e-6, 0.005)
    avg_start = int(n_iters // 1.3)
    jout = jo._chains_run(jo._wrap_objective(jobj, None), *args, jinits,
                          jnp.stack(chain_keys), hist_cap=80,
                          avg_start=avg_start)

    def draws_of(key, i):
        noise_key, sample_key = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.normal(noise_key, (2 * D,), jnp.float64),
                jf.base_sample(sample_key, N_MC, jnp.float64))

    per_chain = [jax.vmap(lambda i, k=k: draws_of(k, i))(
        jnp.arange(n_iters)) for k in chain_keys]
    drawn = dict(
        noise=torch.as_tensor(np.stack([np.asarray(c[0])
                                        for c in per_chain])),
        draws=torch.as_tensor(np.stack([np.asarray(c[1])
                                        for c in per_chain])))
    noise = jax.random.normal(init_key, (n_chains, 2 * D), jnp.float64)
    tinits = to._perturbed_inits(torch.zeros(2 * D, dtype=torch.float64),
                                 n_chains, scale,
                                 torch.as_tensor(np.array(noise)))
    tout = to._chains_run(to._batched_step(tobj, None), *args, tinits,
                          drawn, hist_cap=80, avg_start=avg_start)
    return jout, tout


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
def test_perturbed_chains_match_jax(kind):
    """RMSProp-IA and Adam-IA chains of `perturbed_black_box_vi`, the
    port's batched step on its pure `perturbed_objective`, against the
    JAX package's on shared noise and draws."""
    _assert_runs_match(*_perturbed_run_both(kind))


def test_perturbed_iteration_draws_are_what_an_evaluation_draws():
    """`iteration_draws` draws the noise, then the base draws, from the
    generator, as an evaluation does; the batched step on them is the
    evaluation, chain by chain."""
    _, tm = _models(N=30)
    fam = pt.mean_field_gaussian_variational_family(D)
    obj = pt.perturbed_black_box_vi(fam, tm, 10, perturbation_scale=0.3)
    params = torch.as_tensor(np.random.RandomState(2).normal(
        0, .1, (2, 2 * D)))
    drawn = [obj.iteration_draws(torch.Generator().manual_seed(s),
                                 torch.float64) for s in (3, 4)]
    assert drawn[0]['noise'].shape == (2 * D,)
    assert drawn[0]['draws'].shape == (10, D)
    values, grads, _ = to._batched_step(obj, None)(
        params, {k: torch.stack([d[k] for d in drawn]) for k in drawn[0]})
    for c, s in enumerate((3, 4)):
        value, grad = obj(params[c], torch.Generator().manual_seed(s))
        torch.testing.assert_close(values[c], value, rtol=1e-12, atol=0)
        torch.testing.assert_close(grads[c], grad, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
def test_perturbed_chains_resume_and_mesh_equal_the_whole_run(
        tmp_path, monkeypatch, kind):
    """The public optimizers on `perturbed_black_box_vi`: a checkpointed
    run interrupted after its first segment and resumed, and the chains
    split over a 2-way chain mesh, equal the whole run bit for bit."""
    from viabel_tpu_torch import parallel
    _, tm = _models(N=30)
    fam = pt.mean_field_gaussian_variational_family(D)
    obj = pt.perturbed_black_box_vi(fam, tm, 10, perturbation_scale=PERTURB)
    opt = (pt.rmsprop_IA_optimize_with_rhat if kind == 'rmsprop'
           else pt.adam_IA_optimize_with_rhat)
    path = str(tmp_path / 'perturbed.npz')

    def run(**kw):
        return opt(150, obj, torch.zeros(2 * D, dtype=torch.float64), D,
                   generator=torch.Generator().manual_seed(9),
                   learning_rate=0.02, n_optimisers=2, rhat_window=30,
                   tail_avg_iters=40, device='cpu', **kw)

    whole = run()
    real = to._chains_segment
    calls = {'n': 0}

    def interrupting(*args, **kwargs):
        if calls['n'] >= 1:
            raise KeyboardInterrupt
        calls['n'] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(to, '_chains_segment', interrupting)
    partial = run(checkpoint_path=path, save_every=60)
    monkeypatch.setattr(to, '_chains_segment', real)
    assert partial[1].shape == (2, 60, 2 * D)
    resumed = run(checkpoint_path=path, save_every=60)
    on_mesh = run(mesh=parallel.make_mesh(('chain',), devices=['cpu'] * 2))
    for got in (resumed, on_mesh):
        for k in (0, 1, 4, 5):
            np.testing.assert_array_equal(got[k], whole[k])
        np.testing.assert_array_equal(
            got[6]['averaged_variational_param'],
            whole[6]['averaged_variational_param'])


def test_regression_slice_matches_jax():
    """Averaged fit -> K2's bound pass -> bounds -> PSIS -> accuracy, the
    port against the JAX package on shared draws at a small size."""
    jout, tout = _run_both('rmsprop', avg_start=int(N_ITERS // 1.3))
    jm, tm = _models()
    (jv, jl, jc), _, _ = jout
    (tv, tl, tc), _, _ = tout
    args = (max(N_ITERS // 10, 100), 1.15, 1.20, N_ITERS // 4)
    jres = jo._ia_postprocess(D, jc, jv, jl, *args)
    tres = to._ia_postprocess(D, tc.numpy(), tv.numpy(), tl.numpy(), *args)
    jparam = np.concatenate([jres[0][0][-1], jres[1][0][-1]])
    tparam = np.concatenate([tres[0][0][-1], tres[1][0][-1]])
    np.testing.assert_allclose(tparam, jparam, rtol=RTOL)

    n, seed = 20000, 123456789
    jf = vt.mean_field_gaussian_variational_family(D)
    tf = pt.mean_field_gaussian_variational_family(D)
    tp = torch.as_tensor(tparam)
    tlw, _ = gaussian_sample_score_partials(tp[:D], tp[D:], n, seed, 0,
                                            tm.kernel, tm.kernel_data)
    z = philox_normal_plain(n, D, seed, 0, dtype=torch.float64)
    jx = jf.transform(jnp.asarray(jparam), jnp.asarray(z.numpy()))
    jlw = jm.log_prob(jx) - jf.log_prob(jnp.asarray(jparam), jx)
    np.testing.assert_allclose(tlw.numpy(), np.asarray(jlw), rtol=1e-12,
                               atol=1e-10)

    tb = pt.all_bounds(tlw, q_var=tf.mean_and_cov(tp)[1].numpy(),
                       moment_bound_fn=pt.bounds.family_moment_bounds(tf, tp))
    jb = vt.all_bounds(jlw, q_var=np.asarray(jf.mean_and_cov(
        jnp.asarray(jparam))[1]), moment_bound_fn=lambda p: float(
            jf.pth_moment(jnp.asarray(jparam), p)))
    for k in ('d2', 'W1', 'W2', 'mean_error', 'std_error', 'cov_error'):
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-9)

    tsamples = tf.transform(tp, z)
    tslw, tkhat = pt.psislw(tlw)
    jslw, jkhat = j_psislw(jlw)
    np.testing.assert_allclose(float(tkhat), float(jkhat), rtol=1e-9)
    tmean, tcov = pt.weighted_moments(tsamples, tslw)
    jmean, jcov = j_weighted_moments(jx, jslw)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-9)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-9,
                               atol=1e-14)
    tacc = pt.check_accuracy(tm.true_mean, tm.true_cov, tmean, tcov)
    jacc = j_check_accuracy(jm.true_mean, jm.true_cov, np.asarray(jmean),
                            np.asarray(jcov))
    for k in jacc:
        np.testing.assert_allclose(tacc[k], jacc[k], rtol=1e-8)
