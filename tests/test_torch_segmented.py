"""The port's segmented IA chain runs, progress lines and chains of
objectives that sample inside the step, against viabel_tpu.optimizers,
float64.

The segmented runs compare on shared per-chain draws (each chain's block
the JAX package's ``make_draws_range(chain_key, 0, n_iters)``, shared
init noise) at rtol 1e-10, with a history cap shorter and longer than a
segment.  A chain that samples inside its step is held two ways: its
arithmetic on the JAX package's per-iteration draws (``fold_in(chain_key,
i)``'s base draws, fed to the port's batched step), and its statistics,
since the port's Philox stream is not threefry: the fit's mean against
the JAX package's 16-seed spread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import optimizers as jo
from viabel_tpu_torch import interop
from viabel_tpu_torch import optimizers as to

RTOL = 1e-10
D, N_MC = 3, 20
MU = np.array([0.5, -1.0, 2.0])
SD = np.array([0.7, 1.3, 0.4])


def _jax_target(x):
    return -0.5 * jnp.sum(((x - MU) / SD) ** 2, axis=-1)


def _torch_target(x):
    mu, sd = torch.as_tensor(MU, dtype=x.dtype), torch.as_tensor(SD,
                                                                 dtype=x.dtype)
    return -0.5 * torch.sum(((x - mu) / sd) ** 2, dim=-1)


def _objectives(presampled, family='gaussian'):
    if family == 'gaussian':
        jf = vt.mean_field_gaussian_variational_family(D)
        tf = pt.mean_field_gaussian_variational_family(D)
    else:
        jf = vt.mean_field_t_variational_family(D, 40)
        tf = pt.mean_field_t_variational_family(D, 40)
    return (vt.black_box_klvi(jf, _jax_target, N_MC, presampled=presampled),
            pt.black_box_klvi(tf, _torch_target, N_MC,
                              presampled=presampled))


def _shared(kind, n_chains, n_iters, seed=0):
    """The JAX package's chain keys and inits, the port's inits from the
    same noise, and each chain's draws (fold_in(key, i)'s base draws)."""
    jpre, _ = _objectives(True)
    scale = 0.5 if kind == 'rmsprop' else 0.2
    init_key, *chain_keys = jax.random.split(jax.random.PRNGKey(seed),
                                             n_chains + 1)
    init = jnp.zeros(2 * D, dtype=jnp.float64)
    jinits = jo._perturbed_inits(init, n_chains, scale, init_key)
    noise = jax.random.normal(init_key, (n_chains, 2 * D), jnp.float64)
    tinits = to._perturbed_inits(torch.zeros(2 * D, dtype=torch.float64),
                                 n_chains, scale,
                                 torch.as_tensor(np.array(noise)))
    draws = interop.chain_draws(np.stack([
        np.asarray(jpre.make_draws_range(k, 0, n_iters, jnp.float64))
        for k in chain_keys]))
    return jnp.stack(chain_keys), jinits, tinits, draws


def _close(got, want):
    assert tuple(np.shape(got)) == tuple(np.shape(want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-12)


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
@pytest.mark.parametrize('hist_cap,save_every', [(100, 250), (500, 100)])
def test_chains_run_segmented_matches_jax(kind, hist_cap, save_every):
    """History cap shorter than a segment (only the segment's last `cap`
    entries survive) and longer (the cap spans segments)."""
    n_iters, n_chains, avg_start = 350, 2, int(350 // 1.3)
    jkeys, jinits, tinits, draws = _shared(kind, n_chains, n_iters)
    jobj, tobj = _objectives(True)
    args = (kind, n_iters, 0.02, 1e-6, None)
    jout = jo._chains_run_segmented(
        jo._wrap_objective(jobj, None), *args, jinits, jkeys, hist_cap,
        avg_start, save_every, None, False)
    step = to._batched_step(tobj, None)
    tout = to._chains_run_segmented(
        step, *args, tinits, draws, np.zeros((n_chains, 1), np.uint8),
        hist_cap, avg_start, save_every, None, False)
    (jv, jl, jc), jfinal, javg, ji = jout
    (tv, tl, tc), tfinal, tavg, ti = tout
    assert ti == ji == n_iters and tc.shape[1] == min(hist_cap, n_iters)
    for got, want in ((tv, jv), (tl, jl), (tc, jc), (tfinal, jfinal),
                      (tavg, javg)):
        _close(got, want)
    # the segmented run is the whole run, bit for bit
    (wv, wl, wc), wfinal, wavg = to._chains_run(
        step, *args, tinits, draws, hist_cap=hist_cap, avg_start=avg_start)
    for got, want in ((tv, wv), (tl, wl), (tc, wc), (tfinal, wfinal),
                      (tavg, wavg)):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize('kind', ['rmsprop', 'adam'])
def test_generator_driven_chains_arithmetic_matches_jax(kind):
    """Chains of an objective that samples inside its step: fed the JAX
    package's per-iteration draws through the port's batched step, they
    follow the JAX package's key-driven chains at rtol 1e-10."""
    n_iters, n_chains = 200, 3
    jkeys, jinits, tinits, draws = _shared(kind, n_chains, n_iters, seed=4)
    jobj, tobj = _objectives(False)
    args = (kind, n_iters, 0.03, 1e-6, 0.005)
    jout = jo._chains_run(jo._wrap_objective(jobj, None), *args, jinits,
                          jkeys, hist_cap=150, avg_start=120)
    tout = to._chains_run(to._batched_step(tobj, None), *args, tinits,
                          draws, hist_cap=150, avg_start=120)
    (jv, jl, jc), jfinal, javg = jout
    (tv, tl, tc), tfinal, tavg = tout
    for got, want in ((tv, jv), (tl, jl), (tc, jc), (tfinal, jfinal),
                      (tavg, javg)):
        _close(got.numpy(), want)


def _ia_kw(**kw):
    return dict(n_optimisers=2, rhat_window=50, tail_avg_iters=50,
                device='cpu', **kw)


@pytest.mark.parametrize('presampled', [True, False])
def test_interrupt_returns_partial_results_and_resume_completes(
        tmp_path, monkeypatch, presampled):
    """A KeyboardInterrupt after two segments returns their histories; an
    identical call resumes from the checkpoint and reproduces the
    uninterrupted run (viabel_tpu's test_ia_interrupt_partial_results_and_
    resume)."""
    _, obj = _objectives(presampled)
    init = torch.zeros(2 * D, dtype=torch.float64)
    path = str(tmp_path / 'resume.npz')

    def run(**kw):
        return pt.adam_IA_optimize_with_rhat(
            300, obj, init, D, generator=torch.Generator().manual_seed(12),
            **_ia_kw(**kw))

    whole = run()
    real = to._chains_segment
    calls = {'n': 0}

    def interrupting(*args, **kwargs):
        if calls['n'] >= 2:
            raise KeyboardInterrupt
        calls['n'] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(to, '_chains_segment', interrupting)
    partial = run(checkpoint_path=path, save_every=100)
    monkeypatch.setattr(to, '_chains_segment', real)
    assert partial[1].shape == (2, 200, 2 * D)
    np.testing.assert_array_equal(partial[1], whole[1][:, :200])
    assert partial[4].shape == (2 * 200,)
    resumed = run(checkpoint_path=path, save_every=100)
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(resumed[k], whole[k])
    np.testing.assert_array_equal(
        resumed[6]['averaged_variational_param'],
        whole[6]['averaged_variational_param'])


def test_interrupt_before_first_segment_reraises(monkeypatch):
    _, obj = _objectives(True)

    def interrupt_immediately(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(to, '_chains_segment', interrupt_immediately)
    with pytest.raises(KeyboardInterrupt):
        pt.adam_IA_optimize_with_rhat(
            300, obj, torch.zeros(2 * D, dtype=torch.float64), D,
            progress=True, save_every=100, **_ia_kw())


@pytest.mark.parametrize('presampled', [True, False])
def test_mf_t_segmented_equals_whole_run(tmp_path, presampled):
    """The t family's draws are drawn once for the whole run and sliced
    (presampled), or drawn at each iteration from fold_in(seed, i): either
    way a segmented run, with progress and a checkpoint, is the whole
    run."""
    _, obj = _objectives(presampled, family='t')
    init = torch.zeros(2 * D, dtype=torch.float64)
    kw = _ia_kw(generator=None)
    whole = pt.rmsprop_IA_optimize_with_rhat(250, obj, init, D, **kw)
    seg = pt.rmsprop_IA_optimize_with_rhat(
        250, obj, init, D, checkpoint_path=str(tmp_path / 'c.npz'),
        save_every=60, progress=True, **kw)
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(seg[k], whole[k])
    assert seg[6]['start_avg_mean_iters'] == whole[6]['start_avg_mean_iters']


def test_progress_lines_match_jax(capsys):
    """The segment lines and the adagrad lines are the JAX package's
    text."""
    tail = np.array([[1.5, 2.25], [3.0, 4.5]])
    for i_done in (100, 300):
        jo._segment_progress(i_done, 300, tail)
        want = capsys.readouterr().out
        to._segment_progress(i_done, 300, tail)
        assert capsys.readouterr().out == want
    for i in (0, 41, 99):
        jo._progress_report(i, 100, 12345.678)
        want = capsys.readouterr().out
        to._progress_report(i, 100, torch.tensor(12345.678))
        assert capsys.readouterr().out == want


@pytest.mark.parametrize('presampled', [True, False])
def test_adagrad_progress_prints_and_changes_no_bit(capsys, presampled):
    """adagrad_optimize(progress=True) prints the JAX package's report
    points (every n_iters // 100 and the last) and returns the same bits
    as a silent run."""
    _, obj = _objectives(presampled)
    init = torch.zeros(2 * D, dtype=torch.float64)

    def run(progress):
        return pt.adagrad_optimize(
            250, obj, init, generator=torch.Generator().manual_seed(3),
            progress=progress, device='cpu')

    quiet = run(False)
    assert capsys.readouterr().out == ''
    loud = run(True)
    out = capsys.readouterr().out
    for got, want in zip(loud, quiet):
        assert torch.equal(got, want)
    lines = out.split('\r')[1:]
    assert len(lines) == len(range(0, 250, 2)) + 1
    assert lines[0].startswith('  iter       1/250 | loss = ')
    assert lines[-1].startswith('  iter     250/250 | loss = ')
    assert out.endswith('\n')
    assert '{:<12.6g}'.format(float(quiet[2][100])) in lines[50]


def test_generator_driven_chains_statistics_match_jax():
    """The IA fit of chains that sample inside the step: the port's
    averaged mean over 4 seeds lies within the JAX package's 16-seed
    spread (mean +- 4 sd of the mean of 4) in every coordinate."""
    jobj, tobj = _objectives(False)
    n_iters = 300
    kw = dict(learning_rate=0.05, n_optimisers=2, rhat_window=50,
              tail_avg_iters=100)

    def fit_mean(out):
        return np.asarray(out[2][0][-1])

    jfits = np.stack([fit_mean(vt.rmsprop_IA_optimize_with_rhat(
        n_iters, jobj, jnp.zeros(2 * D, dtype=jnp.float64), D,
        key=jax.random.PRNGKey(s), **kw)) for s in range(16)])
    tfits = np.stack([fit_mean(pt.rmsprop_IA_optimize_with_rhat(
        n_iters, tobj, torch.zeros(2 * D, dtype=torch.float64), D,
        generator=torch.Generator().manual_seed(s), device='cpu', **kw))
        for s in range(4)])
    spread = jfits.std(axis=0, ddof=1)
    z = (tfits.mean(axis=0) - jfits.mean(axis=0)) / (spread / 2)
    assert np.all(np.abs(z) < 4), z
    # and both sit at the target's mean
    np.testing.assert_allclose(jfits.mean(axis=0), MU, atol=0.1)
    np.testing.assert_allclose(tfits.mean(axis=0), MU, atol=0.1)


def test_iteration_draws_are_fold_in_rows():
    """Chain c's draws of iteration i come from a generator seeded with
    fold_in(seed_c, i): the same whatever came before."""
    from viabel_tpu_torch.ops.philox import fold_in
    _, obj = _objectives(False)
    draw = to._generator_draws(obj, [11, 12], 'cpu', torch.float64)
    late = draw(7)
    for c, seed in enumerate((11, 12)):
        g = torch.Generator().manual_seed(fold_in(seed, 7))
        assert torch.equal(late[c], obj.iteration_draws(g, torch.float64))
    assert torch.equal(draw(7), late)
    assert not torch.equal(draw(8), late)
    assert len({fold_in(s, i) for s in (0, 1) for i in range(1000)}) == 2000
