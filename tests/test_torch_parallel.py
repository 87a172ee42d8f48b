"""The port's multi-device layer (viabel_tpu_torch.parallel and the mesh=
of every entry point) against viabel_tpu.parallel, float64.

The JAX package's sharded functions run on the 8 virtual CPU devices
(tests/conftest.py); the port's on meshes of ``['cpu'] * S``, its shards
one after another on the CPU with the kernels' plain versions.  Both take
the same numpy-seeded inputs, at S = 8 (a ``sample`` mesh) and S = (4, 2)
(the ``sample`` axis of a ``(chain, sample)`` mesh):

* the statistics, PSIS (1-D, 2-D columns, the no-smoothing branch, ties in
  the tail), PSIS-LOO and the PSIS moments agree to 1e-10 relative;
* `auto_mesh` gives the JAX package's shapes and notes, word for word;
* the chains of the IA optimizers and the runs of the batch core, fed the
  JAX package's draws, agree with its chain-sharded runs to 1e-8;
* the entry points refuse a mesh without the axis, or of a size that does
  not divide, with the JAX package's messages.

Then the port against itself: each sharded pass against the unsharded
pass on the concatenation of its shards' draws (the K2 row-range route
against the unsharded stream), and every entry point's ``mesh=`` against
its run without one (the optimizers and HMC bit for bit).
"""
import contextlib
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
import viabel_tpu_torch.parallel as pp
from viabel_tpu import optimizers as jo
from viabel_tpu import parallel as jp
from viabel_tpu.models import robust_regression_model as jrr
from viabel_tpu_torch import interop
from viabel_tpu_torch import optimizers as to
from viabel_tpu_torch.bounds import all_bounds, family_moment_bounds
from viabel_tpu_torch.models import eight_schools_ncp_model
from viabel_tpu_torch.models import funnel_model as tfunnel
from viabel_tpu_torch.models import regression as tr
from viabel_tpu_torch.models import robust_regression_model as trr
from viabel_tpu_torch.ops.gaussian_lw import (gaussian_sample_score_partials,
                                              philox_normal)
from viabel_tpu_torch.ops.philox import fold_in, philox_seed
from viabel_tpu_torch.optimizers import _learning_rates
from viabel_tpu_torch.parallel.sharded_bounds import _pass as sharded_pass
from viabel_tpu_torch.pipeline import _batch_core, _bound_and_psis
from viabel_tpu_torch.psis import _tail_len, psislw

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

RTOL = 1e-10
STATS = ('log_rescale', 'mean_rescaled_alpha', 'std_rescaled_alpha',
         'mean_lw', 'std_lw')
MESHES = ('S8', 'S4x2')


def _meshes(name):
    """The JAX mesh and the port's mesh of `name`."""
    if name == 'S8':
        return (jp.make_mesh(axis_names=('sample',), shape=(8,)),
                pp.make_mesh(('sample',), devices=['cpu'] * 8))
    return (jp.make_mesh(axis_names=('chain', 'sample'), shape=(4, 2)),
            pp.make_mesh(('chain', 'sample'), shape=(4, 2),
                         devices=['cpu'] * 8))


def _close(got, want, rtol=RTOL, atol=0.0, what=''):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# the sharded estimators against the JAX package's
# --------------------------------------------------------------------------

def _check_log_weight_stats(mesh, lw):
    jm, tm = _meshes(mesh)
    want = jp.sharded_log_weight_stats(jp.shard_over(jnp.asarray(lw), jm,
                                                     'sample'), jm)
    got = pp.sharded_log_weight_stats(lw, tm)
    assert got['n'] == want['n'] == lw.size
    for k in STATS:
        _close(got[k], want[k], what=k)
    return got


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('shape', [(8000,), (4000, 3)])
def test_log_weight_stats_match_jax(mesh, shape):
    _check_log_weight_stats(mesh, 1.5 * _rng(0).standard_normal(shape)
                            - 40.0)


def _dead_rows(n, S, dead):
    """The rows of shard `dead` of the 8-way mesh (its counterpart, shard
    ``dead * S // 8``, on an S-way sample axis), or every row."""
    if dead == 'all':
        return slice(None)
    k = dead * S // 8
    return slice(k * n // S, (k + 1) * n // S)


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('dead', [0, 3, 7, 'all'])
def test_log_weight_stats_with_an_all_inf_shard_match_jax(mesh, dead):
    """A shard whose log-weights are all -inf adds its count and nothing
    to the rescaled moments (ROADMAP C.1); every shard -inf gives the JAX
    package's NaN (exp(-inf - -inf))."""
    lw = _rng(0).standard_normal(8000)
    S = _meshes(mesh)[1].shape['sample']
    lw[_dead_rows(lw.size, S, dead)] = -np.inf
    got = _check_log_weight_stats(mesh, lw)
    unsharded = pt.log_weight_stats(torch.as_tensor(lw))
    for k in STATS:
        _close(got[k], unsharded[k], what=k)
    if dead == 'all':
        assert np.isnan(got['mean_rescaled_alpha'])
    else:
        assert np.isfinite(got['mean_rescaled_alpha'])
        assert np.isfinite(got['std_rescaled_alpha'])


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('dead', [3, 'all'])
def test_bound_pass_with_an_all_inf_shard_matches_jax(mesh, dead):
    """The bound pass through `_draw_shards`: a density that is -inf on
    one shard's rows (its base draws moved where the density is -inf)
    scored and reduced a shard at a time, then merged; its statistics
    equal the JAX package's sharded statistics of the same log-weights."""
    jm, tm = _meshes(mesh)
    S, n = tm.shape['sample'], 8000
    fam = pt.mean_field_gaussian_variational_family(2)
    vp = torch.tensor([0.2, -0.1, -0.3, 0.1], dtype=torch.float64)
    z = _rng(4).standard_normal((n, 2))
    z[_dead_rows(n, S, dead), 0] += 1000.0

    def density(x):
        inside = -0.5 * torch.sum(x ** 2, dim=1)
        return torch.where(x[:, 0] > 50.0, -torch.inf, inside)

    out = sharded_pass(density, fam, vp, n, torch.as_tensor(z),
                       tm.line('sample'), 2.0, tm.home())
    lw = torch.cat([out['lw'][i] for i in range(S)]).numpy()
    assert np.isneginf(lw[_dead_rows(n, S, dead)]).all()
    want = jp.sharded_log_weight_stats(jp.shard_over(jnp.asarray(lw), jm,
                                                     'sample'), jm)
    got = out['stats'].numpy()
    for j, k in enumerate(STATS):
        _close(got[j], want[k], what=k)
    assert np.isnan(got[1]) == (dead == 'all')


@pytest.mark.parametrize('mesh', MESHES)
def test_sample_stats_match_jax(mesh):
    jm, tm = _meshes(mesh)
    x = _rng(1).standard_normal((4000, 3)) * [1.0, 2.0, 0.5] + 3.0
    want = jp.sharded_sample_stats(jp.shard_over(jnp.asarray(x), jm,
                                                 'sample'), jm)
    got = pp.sharded_sample_stats(pp.shard_over(x, tm, 'sample'), tm)
    for k in ('C2', 'C4', 'cov'):
        _close(got[k].numpy(), want[k], what=k)


def _psis_input(case):
    rng = _rng(2)
    if case == '1d':
        return rng.standard_normal(8000) * 1.3
    if case == '2d':
        return rng.standard_normal((4000, 3)) * [0.5, 1.0, 2.0]
    if case == 'no_smoothing':  # light tail: k < 1/3, weights unsmoothed
        return -np.abs(rng.standard_normal(8000)) * 0.01
    lw = rng.standard_normal(8000)
    lw[:64] = np.sort(lw)[-200]  # exact ties inside the tail
    return lw


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('case', ['1d', '2d', 'no_smoothing', 'ties'])
def test_psislw_matches_jax(mesh, case):
    jm, tm = _meshes(mesh)
    lw = _psis_input(case)
    jslw, jk = jp.psislw_sharded(jp.shard_over(jnp.asarray(lw), jm,
                                               'sample'), jm)
    tslw, tk = pp.psislw_sharded(lw, tm)
    _close(tk.numpy(), jk, what='khat')
    _close(pp.fetch_global(tslw), jslw, atol=1e-12, what='smoothed')
    if case == 'no_smoothing':
        assert float(tk) < 1 / 3
    if case == 'ties':  # every tie takes one quantile, as the JAX package's
        assert np.unique(pp.fetch_global(tslw)[:64]).size == 1


@pytest.mark.parametrize('mesh', MESHES)
def test_psisloo_matches_jax(mesh):
    jm, tm = _meshes(mesh)
    log_lik = -0.5 * _rng(3).standard_normal((4000, 4)) ** 2 - 1.0
    want = jp.psisloo_sharded(jp.shard_over(jnp.asarray(log_lik), jm,
                                            'sample'), jm)
    got = pp.psisloo_sharded(log_lik, tm)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize('mesh', MESHES)
def test_psis_moments_match_jax(mesh):
    jm, tm = _meshes(mesh)
    rng = _rng(4)
    x = rng.standard_normal((8000, 2))
    lw = -0.5 * np.sum(x ** 2, axis=1) * 0.3 + rng.standard_normal(8000)
    jslw, _ = jp.psislw_sharded(jp.shard_over(jnp.asarray(lw), jm,
                                              'sample'), jm)
    jmean, jcov = jp.sharded_psis_moments(
        jp.shard_over(jnp.asarray(x), jm, 'sample'), jslw, jm)
    tslw, _ = pp.psislw_sharded(lw, tm)
    tmean, tcov = pp.sharded_psis_moments(pp.shard_over(x, tm, 'sample'),
                                          tslw, tm)
    _close(tmean.numpy(), jmean)
    _close(tcov.numpy(), jcov)


# --------------------------------------------------------------------------
# the sharded port against the unsharded port on the same draws
# --------------------------------------------------------------------------

def _shard_draws(family, seed, n, S, dtype=torch.float64):
    """The base draws a sharded pass of `seed` scores: shard i's from
    ``fold_in(seed, i)``, concatenated in shard order."""
    return torch.cat([family.base_sample(
        torch.Generator().manual_seed(fold_in(seed, i)), n // S, dtype)
        for i in range(S)])


def _funnel_case(density):
    fam = pt.mean_field_t_variational_family(2, 40)
    vp = torch.tensor([0.1, -0.2, 0.3, 0.6], dtype=torch.float64)
    model = tfunnel()
    # a bare callable has no kernel tag: scored in torch, reduced by K3
    return fam, vp, model if density == 'kernel' else model.log_prob


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('density', ['kernel', 'torch'])
@pytest.mark.parametrize('moments', ['closed', 'empirical'])
def test_sharded_all_bounds_match_unsharded_on_their_draws(mesh, density,
                                                           moments):
    _, tm = _meshes(mesh)
    fam, vp, model = _funnel_case(density)
    n, seed, S = 16000, 12345, tm.shape['sample']
    mb = family_moment_bounds(fam, vp) if moments == 'closed' else None
    q_var = fam.mean_and_cov(vp)[1].numpy() if moments == 'closed' else None
    got, lw = pp.sharded_all_bounds(model, fam, vp, n, seed, tm,
                                    moment_bound_fn=mb, q_var=q_var,
                                    return_log_weights=True)
    z = _shard_draws(fam, seed, n, S)
    samples = fam.transform(vp, z)
    want_lw = (model(samples) if callable(model) else model.log_prob(
        samples)) - fam.log_prob(vp, samples)
    _close(pp.fetch_global(lw), want_lw.numpy(), what='lw')
    want = all_bounds(want_lw, samples=samples if mb is None else None,
                      moment_bound_fn=mb, q_var=q_var)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k)


@pytest.mark.parametrize('mesh', MESHES)
def test_sharded_bound_psis_matches_unsharded_on_its_draws(mesh):
    _, tm = _meshes(mesh)
    fam, vp, model = _funnel_case('kernel')
    n, seed, S = 16000, 99, tm.shape['sample']
    mb = family_moment_bounds(fam, vp)
    q_var = fam.mean_and_cov(vp)[1].numpy()
    res, slw, khat = pp.sharded_bound_psis(model, fam, vp, n, seed, tm,
                                           moment_bound_fn=mb, q_var=q_var)
    samples = fam.transform(vp, _shard_draws(fam, seed, n, S))
    lw = model.log_prob(samples) - fam.log_prob(vp, samples)
    want = all_bounds(lw, moment_bound_fn=mb, q_var=q_var)
    for k in want:
        _close(res[k], want[k], what=k)
    want_slw, want_khat = psislw(lw)
    _close(khat, float(want_khat))
    _close(pp.fetch_global(slw), want_slw.numpy(), atol=1e-12)


def _regression():
    data = tr.data_generator_linear(N=50, D=4, alpha=1.0,
                                    noise_variance=0.25, rho=0.5, seed=3)
    model = tr.linear_regression_model(data['X'], data['Y'])
    fam = pt.mean_field_gaussian_variational_family(4)
    vp = torch.tensor([0.3, -0.1, 0.2, 0.5, -1.0, -1.2, -0.9, -1.1],
                      dtype=torch.float64)
    return model, fam, vp


@pytest.mark.parametrize('mesh', MESHES)
def test_k2_row_range_route_matches_the_unsharded_stream(mesh):
    """A mean-field Gaussian q of a kernel-tagged model: shard i scores rows
    [i n / S, (i + 1) n / S) of the seed's stream with K2 (and writes them
    with philox_normal), so the sharded pass is the unsharded pass."""
    _, tm = _meshes(mesh)
    model, fam, vp = _regression()
    n, seed = 16000, 2 ** 63 + 17
    got, lw, samples = pp.sharded_all_bounds(
        model, fam, vp, n, seed, tm, return_log_weights=True,
        return_samples=True)
    want_lw, _ = gaussian_sample_score_partials(
        vp[:4], vp[4:], n, seed, 0, model.kernel,
        model.kernel_data_like(vp))
    want_samples = fam.transform(vp, philox_normal(n, 4, seed, 0, 0,
                                                   torch.float64))
    _close(pp.fetch_global(lw), want_lw.numpy(), what='lw')
    _close(pp.fetch_global(samples), want_samples.numpy(), what='samples')
    want = all_bounds(want_lw, samples=want_samples)
    for k in want:
        _close(got[k], want[k], what=k)


def test_k2_start_is_the_stream_offset():
    model, fam, vp = _regression()
    seed = 7
    whole, _ = gaussian_sample_score_partials(
        vp[:4], vp[4:], 3000, seed, 0, model.kernel, model.kernel_data_like(
            vp))
    part, _ = gaussian_sample_score_partials(
        vp[:4], vp[4:], 1000, seed, 0, model.kernel, model.kernel_data_like(
            vp), start=1500)
    np.testing.assert_array_equal(part.numpy(), whole[1500:2500].numpy())


# --------------------------------------------------------------------------
# auto_mesh: the JAX package's shapes and notes
# --------------------------------------------------------------------------

def _placement(mesh):
    if mesh is None:
        return None
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


@pytest.mark.parametrize('n_dev', range(1, 9))
def test_auto_mesh_matches_jax(n_dev):
    for k in (1, 2, 3, 4, 6, 8, 12, 16):
        for n in (None, 1000, 4096, 4097, 4098, 999983):
            jm, jnote = jp.auto_mesh(k, n, devices=jax.devices()[:n_dev])
            tm, tnote = pp.auto_mesh(k, n, devices=['cpu'] * n_dev)
            assert _placement(tm) == _placement(jm), (n_dev, k, n)
            assert tnote == jnote, (n_dev, k, n)


@pytest.mark.parametrize('k,n', [(1, 4096), (4, 4096), (8, 4096), (3, 4096),
                                 (1, 4097), (4, 4097), (1, 4098)])
def test_auto_mesh_degraded_cases_match_jax(k, n):
    """The placements and notes of tests/test_parallel.py:328-367."""
    jm, jnote = jp.auto_mesh(k, n)
    tm, tnote = pp.auto_mesh(k, n, devices=['cpu'] * 8)
    assert _placement(tm) == _placement(jm)
    assert tnote == jnote


def test_auto_mesh_without_devices_is_single_device():
    assert pp.auto_mesh(4, 4096, devices=['cpu']) == (None, None)
    assert pp.auto_mesh(4, 4096, devices=[]) == (None, None)


# --------------------------------------------------------------------------
# chains and batches on a chain mesh, fed the JAX package's draws
# --------------------------------------------------------------------------

D_IA, N_MC_IA = 3, 20
MU = np.array([0.5, -1.0, 2.0])
SD = np.array([0.7, 1.3, 0.4])


def _jax_target(x):
    return -0.5 * jnp.sum(((x - MU) / SD) ** 2, axis=-1)


def _torch_target(x):
    mu = torch.as_tensor(MU, dtype=x.dtype)
    sd = torch.as_tensor(SD, dtype=x.dtype)
    return -0.5 * torch.sum(((x - mu) / sd) ** 2, dim=-1)


def _ia_shared(kind, n_chains, n_iters):
    jf = vt.mean_field_gaussian_variational_family(D_IA)
    tf = pt.mean_field_gaussian_variational_family(D_IA)
    jobj = vt.black_box_klvi(jf, _jax_target, N_MC_IA, presampled=True)
    tobj = pt.black_box_klvi(tf, _torch_target, N_MC_IA, presampled=True)
    scale = 0.5 if kind == 'rmsprop' else 0.2
    init_key, *chain_keys = jax.random.split(jax.random.PRNGKey(5),
                                             n_chains + 1)
    jinits = jo._perturbed_inits(jnp.zeros(2 * D_IA, dtype=jnp.float64),
                                 n_chains, scale, init_key)
    noise = jax.random.normal(init_key, (n_chains, 2 * D_IA), jnp.float64)
    tinits = to._perturbed_inits(torch.zeros(2 * D_IA, dtype=torch.float64),
                                 n_chains, scale,
                                 torch.as_tensor(np.array(noise)))
    draws = interop.chain_draws(np.stack([
        np.asarray(jobj.make_draws_range(k, 0, n_iters, jnp.float64))
        for k in chain_keys]))
    return jobj, tobj, jnp.stack(chain_keys), jinits, tinits, draws


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
@pytest.mark.parametrize('driver', ['whole', 'segmented'])
def test_ia_chains_on_a_chain_mesh_match_jax(kind, driver):
    n_iters, n_chains, hist_cap = 240, 4, 150
    avg_start = int(n_iters // 1.3)
    jobj, tobj, jkeys, jinits, tinits, draws = _ia_shared(kind, n_chains,
                                                          n_iters)
    jm, tm = _meshes('S4x2')
    jinits_s, jkeys_s = jp.shard_chain_inputs(jinits, jkeys, jm)
    args = (kind, n_iters, 0.02, 1e-6, None)
    jstep = jo._wrap_objective(jobj, None)
    tstep = to._batched_step(tobj, None)
    if driver == 'whole':
        (jv, jl, jc), jfin, javg = jo._chains_run(
            jstep, *args, jinits_s, jkeys_s, hist_cap=hist_cap,
            avg_start=avg_start)
        (tv, tl, tc), tfin, tavg = to._chains_run(
            tstep, *args, tinits, draws, hist_cap=hist_cap,
            avg_start=avg_start, mesh=tm)
    else:
        (jv, jl, jc), jfin, javg, _ = jo._chains_run_segmented(
            jstep, *args, jinits_s, jkeys_s, hist_cap, avg_start, 100, None,
            False, mesh=jm)
        (tv, tl, tc), tfin, tavg, _ = to._chains_run_segmented(
            tstep, *args, tinits, draws, np.zeros((n_chains, 1), np.uint8),
            hist_cap, avg_start, 100, None, False, mesh=tm)
    for got, want in ((tv, jv), (tl, jl), (tc, jc), (tfin, jfin),
                      (tavg, javg)):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == np.shape(want)
        _close(got, jp.fetch_global(want), rtol=1e-8, atol=1e-12)


N_ITERS_B, N_BOUND_B, K_B = 120, 4000, 4
B_KEYS = ('opt_param', 'value_history', 'q_mean', 'q_cov', 'psis_mean',
          'psis_cov')


@pytest.mark.parametrize('layout', ['chain', 'chain_sample'])
def test_batch_core_on_a_chain_mesh_matches_jax(layout):
    """`_batch_core` with a chain mesh, fed the JAX package's inits and
    draws (on a (chain, sample) mesh each start's bound draws are its
    shards' ``fold_in(draw_key, i)`` draws), against the JAX package's
    chain-sharded `validated_vi_multistart`."""
    jf = vt.mean_field_t_variational_family(2, 40)
    tf = pt.mean_field_t_variational_family(2, 40)
    jm_model, tm_model = jrr(), trr()
    jobj = vt.black_box_klvi(jf, jm_model.log_prob, 20, presampled=True)
    tobj = pt.black_box_klvi(tf, tm_model, 20, presampled=True)
    init = jnp.asarray([0.0, 0.0, 1.0, 1.0])
    if layout == 'chain':
        jmesh = jp.make_mesh(axis_names=('chain',), shape=(4,),
                             devices=jax.devices()[:4])
        tmesh = pp.make_mesh(('chain',), devices=['cpu'] * 4)
        S = 1
    else:
        jmesh, tmesh = _meshes('S4x2')
        S = 2
    key = jax.random.PRNGKey(7)
    want = vt.validated_vi_multistart(
        jm_model.log_prob, jf, init, N_ITERS_B, n_starts=K_B,
        objective_and_grad=jobj, n_bound_samples=N_BOUND_B, key=key,
        learning_rate=0.05, mesh=jmesh)
    perturb_key, run_key = jax.random.split(key)
    inits = jo._perturbed_inits(init, K_B, 0.5, perturb_key)
    opt, bound = [], []
    for k in range(K_B):
        opt_key, draw_key = jax.random.split(jax.random.fold_in(run_key, k))
        opt.append(np.asarray(jobj.make_draws(opt_key, N_ITERS_B,
                                              jnp.float64)))
        keys = ([draw_key] if S == 1 else
                [jax.random.fold_in(draw_key, i) for i in range(S)])
        bound.append(np.concatenate([np.asarray(jf.base_sample(
            kk, N_BOUND_B // S, jnp.float64)) for kk in keys]))
    lr_tables = _learning_rates(N_ITERS_B, 0.05, None,
                                torch.float64).repeat(K_B, 1)
    out = _batch_core(tobj, None, tf, tm_model, N_ITERS_B, 10, lr_tables,
                      0.1, 2.0, _tail_len(N_BOUND_B, 1.0),
                      torch.tensor(np.asarray(inits)),
                      interop.run_draws(np.stack(opt)),
                      interop.run_draws(np.stack(bound), presampled=False),
                      mesh=tmesh)
    from viabel_tpu_torch.pipeline import _finalize_batch
    got = _finalize_batch(out, N_BOUND_B, 2.0, None)
    for k in B_KEYS:
        _close(got[k].numpy(), jp.fetch_global(want[k]), rtol=1e-8,
               atol=1e-10, what=k)
    for k in ('log_weights', 'smoothed_log_weights'):
        _close(pp.fetch_global(got[k]), jp.fetch_global(want[k]), rtol=1e-8,
               atol=1e-10, what=k)
    _close(got['khat'], want['khat'], rtol=1e-8)
    for b_got, b_want in zip(got['bounds'], want['bounds']):
        for k in b_want:
            _close(b_got[k], b_want[k], rtol=1e-8, what=k)
    assert got['best'] == want['best']


# --------------------------------------------------------------------------
# the JAX package's refusals
# --------------------------------------------------------------------------

def _refusal(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def _entry_calls(pkg_mesh, which):
    """The JAX package's call of an entry point and the port's, on a mesh
    of the JAX test's kind (tests/test_parallel.py:370-398)."""
    jmodel = vt.models.funnel_model()
    jfam = vt.mean_field_gaussian_variational_family(2)
    tmodel = tfunnel()
    tfam = pt.mean_field_gaussian_variational_family(2)
    jinit = jnp.zeros(4, dtype=jnp.float64)
    tinit = torch.zeros(4, dtype=torch.float64)
    jmesh, tmesh = pkg_mesh
    if which == 'validated_vi':
        return (lambda: vt.validated_vi(jmodel.log_prob, jfam, jinit, 50,
                                        n_bound_samples=1000, mesh=jmesh),
                lambda: pt.validated_vi(tmodel, tfam, tinit, 50,
                                        n_bound_samples=1000, mesh=tmesh))
    if which == 'multistart':
        return (lambda: vt.validated_vi_multistart(
                    jmodel.log_prob, jfam, jinit, 50, n_starts=2,
                    n_bound_samples=1001, mesh=jmesh),
                lambda: pt.validated_vi_multistart(
                    tmodel, tfam, tinit, 50, n_starts=2,
                    n_bound_samples=1001, mesh=tmesh))
    if which == 'sweep':
        return (lambda: vt.validated_vi_sweep(
                    jmodel.log_prob, jfam, jinit, 50,
                    learning_rates=[0.01, 0.02, 0.03], mesh=jmesh),
                lambda: pt.validated_vi_sweep(
                    tmodel, tfam, tinit, 50,
                    learning_rates=[0.01, 0.02, 0.03], mesh=tmesh))
    return (lambda: vt.mcmc.hmc_sample(jmodel.log_prob, jnp.zeros(2),
                                       mesh=jmesh, n_samples=10,
                                       n_warmup=10, n_chains=3),
            lambda: pt.hmc_sample(tmodel.log_prob, torch.zeros(2),
                                  mesh=tmesh, n_samples=10, n_warmup=10,
                                  n_chains=3))


def _mesh_pair(names, shape):
    n = int(np.prod(shape))
    return (jp.make_mesh(axis_names=names, shape=shape,
                         devices=jax.devices()[:n]),
            pp.make_mesh(names, shape=shape, devices=['cpu'] * n))


@pytest.mark.parametrize('which,names,shape', [
    ('validated_vi', ('chain',), (8,)),         # no sample axis
    ('validated_vi', ('sample',), (3,)),        # 3 does not divide 1000
    ('multistart', ('sample',), (8,)),          # no chain axis
    ('multistart', ('chain',), (4,)),           # 4 does not divide 2 starts
    ('multistart', ('chain', 'sample'), (2, 2)),  # 2 does not divide 1001
    ('sweep', ('sample',), (8,)),               # no chain axis
    ('sweep', ('chain',), (2,)),                # 2 does not divide 3 rates
    ('hmc', ('sample',), (8,)),                 # no chain axis
    ('hmc', ('chain',), (2,)),                  # 2 does not divide 3 chains
])
def test_mesh_refusals_match_jax(which, names, shape):
    jcall, tcall = _entry_calls(_mesh_pair(names, shape), which)
    assert _refusal(tcall) == _refusal(jcall)


def test_sharded_pass_refusals():
    _, tm = _meshes('S8')
    fam, vp, model = _funnel_case('kernel')
    with pytest.raises(ValueError, match='alpha == 2'):
        pp.sharded_all_bounds(model, fam, vp, 800, 0, tm, alpha=3.0)
    with pytest.raises(ValueError, match=r'mesh axis size \(8\) must divide '
                                         r'n_samples \(801\)'):
        pp.sharded_bound_psis(model, fam, vp, 801, 0, tm)
    with pytest.raises(ValueError, match='split over the mesh axis'):
        pp.psislw_sharded(pp.shard_over(torch.zeros(80, 16), tm, 'sample',
                                        dim=1), tm)


# --------------------------------------------------------------------------
# every entry point's mesh= against its run without one
# --------------------------------------------------------------------------

def _generator(seed=11):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize('mesh', MESHES)
def test_validated_vi_on_a_mesh_matches_unsharded_on_its_draws(mesh):
    _, tm = _meshes(mesh)
    model = trr()
    fam = pt.mean_field_t_variational_family(2, 40)
    obj = pt.black_box_klvi(fam, model, 20, presampled=True)
    init = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    n, n_iters, S = 8000, 150, tm.shape['sample']
    got = pt.validated_vi(model, fam, init, n_iters, objective_and_grad=obj,
                          n_bound_samples=n, generator=_generator(),
                          device='cpu', mesh=tm)
    plain = pt.validated_vi(model, fam, init, n_iters,
                            objective_and_grad=obj, n_bound_samples=n,
                            generator=_generator(), device='cpu')
    # the optimizer takes the unsharded run's draws: bit for bit
    for k in ('opt_param', 'value_history', 'q_mean', 'q_cov'):
        np.testing.assert_array_equal(got[k].numpy(), plain[k].numpy())
    # the bound pass against the unsharded pass on its shards' draws
    g = _generator()
    obj.make_draws(g, n_iters, torch.float64)
    z = _shard_draws(fam, philox_seed(g), n, S)
    want = _bound_and_psis(fam, model, 2.0, _tail_len(n, 1.0),
                           got['opt_param'], z)
    _close(pp.fetch_global(got['log_weights']),
           want['log_weights'].numpy())
    _close(pp.fetch_global(got['smoothed_log_weights']),
           want['smoothed_log_weights'].numpy(), atol=1e-12)
    for k in ('psis_mean', 'psis_cov'):
        _close(got[k].numpy(), want[k].numpy(), what=k)
    _close(got['khat'], float(want['khat']))
    from viabel_tpu_torch.pipeline import _assemble_bounds
    bounds, _, _ = _assemble_bounds(want['stats'], want['moments'],
                                    want['khat'], want['q_cov'], n, 2.0,
                                    None)
    for k in bounds:
        _close(got['bounds'][k], bounds[k], what=k)


@pytest.mark.parametrize('shape', [(2, 1), (2, 2)])
@pytest.mark.parametrize('entry', ['multistart', 'sweep'])
def test_batches_on_a_mesh_keep_the_unsharded_optimizer(shape, entry):
    """Each group draws its runs' draws on its device from the runs' seeds:
    the optimizer runs equal the unsharded batch's bit for bit; with a
    sample axis of one member the whole batch does."""
    model = trr()
    fam = pt.mean_field_t_variational_family(2, 40)
    init = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    tm = pp.make_mesh(('chain', 'sample'), shape=shape,
                      devices=['cpu'] * int(np.prod(shape)))

    def run(mesh):
        kw = dict(n_mc_samples=20, n_bound_samples=4000,
                  generator=_generator(), device='cpu', mesh=mesh)
        if entry == 'multistart':
            return pt.validated_vi_multistart(model, fam, init, 100,
                                              n_starts=4, **kw)
        return pt.validated_vi_sweep(model, fam, init, 100,
                                     learning_rates=[0.01, 0.02, 0.03,
                                                     0.04], **kw)

    got, want = run(tm), run(None)
    for k in ('opt_param', 'value_history', 'q_mean', 'q_cov'):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    if shape[1] == 1:
        for k in ('psis_mean', 'psis_cov'):
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        np.testing.assert_array_equal(pp.fetch_global(got['log_weights']),
                                      want['log_weights'].numpy())
        assert got['khat'] == want['khat'] and got['best'] == want['best']
    else:
        assert np.all(np.isfinite(got['khat']))


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
@pytest.mark.parametrize('presampled', [True, False])
def test_ia_optimizers_on_a_mesh_equal_the_unsharded_run(kind, presampled,
                                                         tmp_path):
    fam = pt.mean_field_gaussian_variational_family(D_IA)
    obj = pt.black_box_klvi(fam, _torch_target, N_MC_IA,
                            presampled=presampled)
    optimize = (pt.rmsprop_IA_optimize_with_rhat if kind == 'rmsprop'
                else pt.adam_IA_optimize_with_rhat)
    _, tm = _meshes('S4x2')
    kw = dict(n_optimisers=4, rhat_window=50, tail_avg_iters=50,
              device='cpu')
    want = optimize(200, obj, torch.zeros(2 * D_IA, dtype=torch.float64),
                    D_IA, generator=_generator(), **kw)
    whole = optimize(200, obj, torch.zeros(2 * D_IA, dtype=torch.float64),
                     D_IA, generator=_generator(), mesh=tm, **kw)
    segmented = optimize(200, obj, torch.zeros(2 * D_IA,
                                               dtype=torch.float64),
                         D_IA, generator=_generator(), mesh=tm,
                         checkpoint_path=str(tmp_path / 'ck.npz'),
                         save_every=80, **kw)
    for got in (whole, segmented):
        for j in (0, 1, 4, 5):
            np.testing.assert_array_equal(got[j], want[j])
        np.testing.assert_array_equal(
            got[6]['averaged_variational_param'],
            want[6]['averaged_variational_param'])


def test_ia_checkpoint_on_a_mesh_resumes_on_the_groups(tmp_path,
                                                       monkeypatch):
    """Interrupted after its first save and resumed, the mesh run's
    checkpoint (its carry returned to the groups' devices) ends where the
    uninterrupted run ends."""
    from viabel_tpu_torch import checkpoint
    fam = pt.mean_field_gaussian_variational_family(D_IA)
    obj = pt.black_box_klvi(fam, _torch_target, N_MC_IA, presampled=True)
    _, tm = _meshes('S4x2')
    kw = dict(n_optimisers=4, rhat_window=50, tail_avg_iters=50,
              device='cpu', mesh=tm, save_every=60)
    init = torch.zeros(2 * D_IA, dtype=torch.float64)
    whole = pt.rmsprop_IA_optimize_with_rhat(
        180, obj, init, D_IA, generator=_generator(),
        checkpoint_path=str(tmp_path / 'a.npz'), **kw)
    real = checkpoint.save_checkpoint
    calls = []

    def interrupt(path, tree):
        real(path, tree)
        calls.append(path)
        if len(calls) == 1:
            raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, 'save_checkpoint', interrupt)
    path = str(tmp_path / 'b.npz')
    pt.rmsprop_IA_optimize_with_rhat(180, obj, init, D_IA,
                                     generator=_generator(),
                                     checkpoint_path=path, **kw)
    monkeypatch.setattr(checkpoint, 'save_checkpoint', real)
    resumed = pt.rmsprop_IA_optimize_with_rhat(
        180, obj, init, D_IA, generator=_generator(), checkpoint_path=path,
        **kw)
    for j in (0, 1, 4):
        np.testing.assert_array_equal(resumed[j], whole[j])


def test_hmc_on_a_chain_mesh_equals_the_unsharded_run():
    model = eight_schools_ncp_model()
    tm = pp.make_mesh(('chain',), devices=['cpu'] * 2)
    kw = dict(n_samples=40, n_warmup=40, n_chains=4, max_steps=8,
              device='cpu')
    init = torch.zeros(10, dtype=torch.float64)
    got = pt.hmc_sample(model.log_prob, init, generator=_generator(),
                        mesh=tm, **kw)
    want = pt.hmc_sample(model.log_prob, init, generator=_generator(), **kw)
    for k in ('samples', 'step_size', 'inv_mass', 'mean', 'cov'):
        _close(got[k], want[k], what=k)
    _close(got['accept_rate'], want['accept_rate'])


@pytest.mark.parametrize('mesh', MESHES)
def test_improve_with_psis_sharded_matches_improve_with_psis(mesh):
    """A mean-field Gaussian q of regression: the sharded pass scores the
    unsharded pass's Philox draws, shard by shard."""
    _, tm = _meshes(mesh)
    model, fam, vp = _regression()
    true_mean, true_cov = np.zeros(4), np.eye(4)
    got = pt.experiments.improve_with_psis_sharded(
        model, fam, vp, 16000, true_mean, true_cov, tm,
        generator=_generator(3))
    want = pt.improve_with_psis(model, fam, vp, 16000, true_mean, true_cov,
                                generator=_generator(3), device='cpu')
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    for k in want[0]:
        _close(got[0][k], want[0][k], what=k)


def _cli(argv, monkeypatch, devices):
    from viabel_tpu_torch import __main__ as cli
    monkeypatch.setattr(cli, '_mesh_devices', lambda device: devices)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cli.main(argv)
    return buf.getvalue()


def test_cli_run_shards_the_bound_stage(monkeypatch):
    """``run`` on 4 devices: the bound stage splits 4 ways and prints the
    bounds and khat of the unsharded pass over its shards' draws."""
    from viabel_tpu_torch.config import ExperimentConfig, build
    from viabel_tpu_torch.config import fit as fit_config
    from viabel_tpu_torch.experiments import _split, print_bounds
    argv = ['run', '--model', 'funnel', '--n-iters', '150', '--device',
            'cpu', '--bound-samples', '4096', '--quiet']
    out = _cli(argv, monkeypatch, ['cpu'] * 4)
    assert 'mesh: 4 devices on the sample axis (bound stage)' in out
    cfg = ExperimentConfig(model='funnel', n_iters=150, bound_samples=4096)
    model, family, objective = build(cfg)
    opt_gen, bound_gen, _ = _split(torch.Generator().manual_seed(cfg.seed),
                                   3)
    opt_param, _, _ = fit_config(cfg, model, family, objective,
                                 generator=opt_gen, device='cpu')
    samples = family.transform(opt_param, _shard_draws(
        family, philox_seed(bound_gen), 4096, 4, opt_param.dtype))
    lw = model.log_prob(samples) - family.log_prob(opt_param, samples)
    res = all_bounds(lw, q_var=family.mean_and_cov(opt_param)[1].numpy(),
                     moment_bound_fn=family_moment_bounds(family, opt_param))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_bounds(res)
        print('khat = {:.3f}{}'.format(float(psislw(lw)[1]), '  (> 0.7: '
                                       'unreliable)' if float(psislw(lw)[1])
                                       > 0.7 else ''))
    assert out.endswith(buf.getvalue())


@pytest.mark.parametrize('flag', [['--starts', '2'], ['--sweep-lr',
                                                      '0.01,0.02']])
def test_cli_batches_on_a_chain_mesh_print_the_unsharded_results(
        monkeypatch, flag):
    """Two runs with two devices: the batch stays on one device (a chain
    mesh gains nothing, PERF.md), says so, and prints the run without
    devices' lines (the chain mesh itself is held to the unsharded batch
    in test_batch_core_on_a_chain_mesh_matches_jax)."""
    argv = ['run', '--model', 'funnel', '--n-iters', '120', '--device',
            'cpu', '--bound-samples', '4096'] + flag
    got = _cli(argv, monkeypatch, ['cpu'] * 2)
    want = _cli(argv, monkeypatch, [])
    note = 'note: 2 devices; the batch runs on one'
    lines = got.splitlines()
    assert note in lines and note not in want.splitlines()
    assert [l for l in lines if l != note] == want.splitlines()


def test_cli_fused_run_on_a_mesh_is_validated_vi_on_it(monkeypatch):
    from viabel_tpu_torch.config import ExperimentConfig, build
    from viabel_tpu_torch.experiments import _split
    argv = ['run', '--model', 'funnel', '--n-iters', '120', '--device',
            'cpu', '--bound-samples', '4096', '--fused']
    out = _cli(argv, monkeypatch, ['cpu'] * 4)
    assert 'mesh: 4 devices on the sample axis' in out
    cfg = ExperimentConfig(model='funnel', n_iters=120, bound_samples=4096)
    model, family, objective = build(cfg)
    opt_gen, _, _ = _split(torch.Generator().manual_seed(cfg.seed), 3)
    res = pt.validated_vi(model, family, family.init_param(device='cpu'),
                          120, objective_and_grad=objective,
                          n_bound_samples=4096, generator=opt_gen,
                          mesh=pp.make_mesh(('sample',),
                                            devices=['cpu'] * 4))
    assert 'khat = {:.3f}'.format(res['khat']) in out


def _service(mesh_devices):
    from viabel_tpu_torch.serve import PosteriorService
    model = tfunnel()
    fam = pt.mean_field_t_variational_family(2, 40)
    vp = torch.tensor([0.1, -0.2, 0.3, 0.6], dtype=torch.float64)
    return model, fam, vp, PosteriorService(model, fam, vp, seed=4,
                                            device='cpu',
                                            mesh_devices=mesh_devices)


def test_service_bounds_through_a_mesh(capsys):
    """/bounds on 4 devices: `sharded_bound_psis` of the request's seed,
    equal to the unsharded pass over its shards' draws."""
    model, fam, vp, service = _service(['cpu'] * 4)
    got = service.bounds(5000)  # rounded up to 8192
    assert '[serve] K=1, n=8192: 4 devices on the sample axis' in \
        capsys.readouterr().out
    seed = philox_seed(torch.Generator().manual_seed(4))
    samples = fam.transform(vp, _shard_draws(fam, seed, 8192, 4))
    lw = model.log_prob(samples) - fam.log_prob(vp, samples)
    want = all_bounds(lw, q_var=fam.mean_and_cov(vp)[1].numpy(),
                      moment_bound_fn=family_moment_bounds(fam, vp))
    want['khat'] = float(psislw(lw)[1])
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k)


@pytest.mark.parametrize('n_starts', [1, 2])
def test_service_fit_through_a_mesh(n_starts, capsys):
    """/fit on 2 devices (one run: a 2-way sample axis; two starts: one
    device, as the command line's batches) against the pipeline on the
    same placement and seed, and the fit itself against the service's fit
    without a mesh."""
    _, fam, vp, service = _service(['cpu'] * 2)
    model, _, _, plain = _service([])
    kw = dict(n_iters=100, n_mc_samples=20, n_bound_samples=4000,
              n_starts=n_starts)
    got, want = service.fit(**kw), plain.fit(**kw)
    placement = ('2 devices on the sample axis' if n_starts == 1 else
                 '2 devices; the batch runs on one')
    assert '[serve] K={}, n=4000: {}'.format(n_starts, placement) in \
        capsys.readouterr().out
    _close(got['mean'], want['mean'], rtol=0)
    _close(got['final_loss'], want['final_loss'], rtol=0)
    mesh, _ = pp.auto_mesh(1, 4000, devices=['cpu'] * 2)
    gen = torch.Generator().manual_seed(philox_seed(
        torch.Generator().manual_seed(4)))
    if n_starts == 1:
        out = pt.validated_vi(model, fam, vp, 100, n_mc_samples=20,
                              n_bound_samples=4000, generator=gen,
                              mesh=mesh)
        bounds, khat = out['bounds'], out['khat']
    else:
        out = pt.validated_vi_multistart(model, fam, vp, 100, n_starts=2,
                                         n_mc_samples=20,
                                         n_bound_samples=4000,
                                         generator=gen, device='cpu')
        bounds, khat = out['bounds'][out['best']], out['khat'][out['best']]
        assert got['best'] == want['best'] == out['best']
        for k in want['bounds']:
            _close(got['bounds'][k], want['bounds'][k], rtol=0)
    for k in bounds:
        _close(got['bounds'][k], bounds[k], what=k)
    _close(got['khat'], khat)
    np.testing.assert_array_equal(service.var_param.numpy(),
                                  plain.var_param.numpy())
