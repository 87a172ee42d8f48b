"""The port's checkpoint module against viabel_tpu.checkpoint, float64.

A checkpoint's entries are named as the JAX package names them, so each
package reads the other's files; the resumable adagrad, fed the JAX
package's draws, follows the JAX package's at rtol 1e-10 in both history
modes, interrupted and resumed; resumed and uninterrupted runs agree bit
for bit on the CPU, with `adagrad_optimize` too; and a checkpoint of
another mode, hyperparameter or seed is refused with the JAX package's
messages (tests/test_extras.py:191-276).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu.checkpoint as jc
import viabel_tpu_torch as pt
import viabel_tpu_torch.checkpoint as tc
from viabel_tpu_torch import interop

RTOL = 1e-10
MU, SD = np.array([0.5, -1.0]), np.array([0.7, 1.3])


def _objectives(presampled=True):
    def jtarget(x):
        return -0.5 * jnp.sum(((x - MU) / SD) ** 2, axis=-1)

    def ttarget(x):
        return -0.5 * torch.sum(((x - torch.as_tensor(MU))
                                 / torch.as_tensor(SD)) ** 2, dim=-1)

    jf = vt.mean_field_gaussian_variational_family(2)
    tf = pt.mean_field_gaussian_variational_family(2)
    return (vt.black_box_klvi(jf, jtarget, 20, presampled=presampled),
            pt.black_box_klvi(tf, ttarget, 20, presampled=presampled))


INIT = np.array([0.1, -0.2, 0.3, 0.0])


def _tree():
    return {'b': torch.arange(6, dtype=torch.float64).reshape(2, 3),
            'a': np.int64(7),
            'nested': {'y': np.array([1.5, 2.5]), 'x': 'tag/v1'},
            'seq': [torch.ones(2), np.zeros(3, np.float32)]}


def test_round_trip_atomic(tmp_path):
    path = str(tmp_path / 'sub' / 'ck.npz')
    tree = _tree()
    assert tc.save_checkpoint(path, tree) == path
    assert sorted(os.listdir(tmp_path / 'sub')) == ['ck.npz']  # no .tmp
    back = tc.load_checkpoint(path, like=tree)
    assert list(back) == sorted(tree)
    np.testing.assert_array_equal(back['b'], tree['b'].numpy())
    assert int(back['a']) == 7 and str(back['nested']['x']) == 'tag/v1'
    np.testing.assert_array_equal(back['nested']['y'], [1.5, 2.5])
    np.testing.assert_array_equal(back['seq'][0], np.ones(2, np.float32))
    assert back['seq'][1].dtype == np.float32
    assert len(tc.load_checkpoint(path)) == 6
    np.testing.assert_array_equal(tc.load_checkpoint_entry(path, 'y'),
                                  [1.5, 2.5])
    with pytest.raises(KeyError, match='no checkpoint entry named'):
        tc.load_checkpoint_entry(path, 'nope')
    assert tc.checkpoint_format(path) is None
    with pytest.raises(ValueError, match='leaves'):
        tc.load_checkpoint(path, like={'a': 1})


def test_entry_names_match_the_jax_package(tmp_path):
    """The same tree saved by both packages: the same entry names, each
    read by the other package's load_checkpoint_entry."""
    host = {'b': np.arange(6.0).reshape(2, 3), 'a': np.int64(7),
            'nested': {'y': np.array([1.5, 2.5]), 'x': np.asarray('tag')},
            'seq': [np.ones(2), np.zeros(3)]}
    pj, pt_ = str(tmp_path / 'j.npz'), str(tmp_path / 't.npz')
    jc.save_checkpoint(pj, host)
    tc.save_checkpoint(pt_, host)
    with np.load(pj) as a, np.load(pt_) as b:
        assert sorted(a.files) == sorted(b.files)
    for name in ('a', 'b', 'y', 'x', '0', '1'):
        np.testing.assert_array_equal(tc.load_checkpoint_entry(pj, name),
                                      jc.load_checkpoint_entry(pt_, name))


def _resumable_files(tmp_path, return_history):
    jobj, tobj = _objectives()
    key = jax.random.PRNGKey(3)
    pj = str(tmp_path / 'j{}.npz'.format(return_history))
    pt_ = str(tmp_path / 't{}.npz'.format(return_history))
    jc.adagrad_optimize_resumable(60, jobj, jnp.asarray(INIT),
                                  checkpoint_path=pj, key=key, save_every=25,
                                  return_history=return_history)
    tc.adagrad_optimize_resumable(60, tobj, torch.as_tensor(INIT),
                                  checkpoint_path=pt_, save_every=25,
                                  return_history=return_history,
                                  device='cpu')
    return pj, pt_


@pytest.mark.parametrize('return_history', [True, False])
def test_resumable_files_readable_by_both_packages(tmp_path,
                                                   return_history):
    pj, pt_ = _resumable_files(tmp_path, return_history)
    fmt = 'adagrad-history/v1' if return_history else 'adagrad-tail/v1'
    for path in (pj, pt_):
        assert jc.checkpoint_format(path) == tc.checkpoint_format(path) == fmt
    with np.load(pj) as a, np.load(pt_) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            if not name.endswith(':key'):  # uint32 key data / uint8 state
                assert a[name].shape == b[name].shape, name
                assert a[name].dtype == b[name].dtype, name
    for name in ('i', 'param', 'values', 'learning_rate'):
        assert (np.shape(jc.load_checkpoint_entry(pt_, name))
                == np.shape(tc.load_checkpoint_entry(pj, name)))
    assert tc.load_checkpoint_entry(pt_, 'key').dtype == np.uint8


def test_chains_files_readable_by_both_packages(tmp_path):
    jobj, tobj = _objectives()
    pj, pt_ = str(tmp_path / 'jc.npz'), str(tmp_path / 'tc.npz')
    kw = dict(n_optimisers=2, rhat_window=20, tail_avg_iters=20,
              save_every=30)
    vt.rmsprop_IA_optimize_with_rhat(60, jobj, jnp.asarray(INIT), 2,
                                     key=jax.random.PRNGKey(0),
                                     checkpoint_path=pj, **kw)
    pt.rmsprop_IA_optimize_with_rhat(60, tobj, torch.as_tensor(INIT), 2,
                                     checkpoint_path=pt_, device='cpu', **kw)
    for path in (pj, pt_):
        assert jc.checkpoint_format(path) == tc.checkpoint_format(path) \
            == 'chains/v1'
    with np.load(pj) as a, np.load(pt_) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            if not name.endswith(':keys'):
                assert a[name].shape == b[name].shape, name
    assert tc.load_checkpoint_entry(pt_, 'keys').shape[0] == 2
    assert str(jc.load_checkpoint_entry(pt_, 'kind')) == 'rmsprop'


def _interrupting_save(monkeypatch, after):
    """Make the port's save_checkpoint raise KeyboardInterrupt once it has
    written `after` checkpoints."""
    real = tc.save_checkpoint
    calls = {'n': 0}

    def save(path, tree):
        if calls['n'] >= after:
            raise KeyboardInterrupt
        calls['n'] += 1
        return real(path, tree)

    monkeypatch.setattr(tc, 'save_checkpoint', save)
    return real


@pytest.mark.parametrize('return_history', [True, False])
def test_resumable_matches_jax_interrupted_and_resumed(tmp_path, monkeypatch,
                                                       return_history):
    """The port's resumable adagrad on the JAX package's draws: interrupted
    after its second checkpoint, resumed, and held against the JAX
    package's uninterrupted run at rtol 1e-10; then against its own
    uninterrupted run and `adagrad_optimize`, bit for bit."""
    jobj, tobj = _objectives()
    n_iters, key = 210, jax.random.PRNGKey(5)
    jout = jc.adagrad_optimize_resumable(
        n_iters, jobj, jnp.asarray(INIT),
        checkpoint_path=str(tmp_path / 'j.npz'), key=key, save_every=50,
        learning_rate=0.05, learning_rate_end=0.01,
        return_history=return_history)
    draws = interop.presampled_draws(
        np.asarray(jobj.make_draws(key, n_iters, jnp.float64)))
    kw = dict(save_every=50, learning_rate=0.05, learning_rate_end=0.01,
              return_history=return_history, device='cpu', draws=draws)
    path = str(tmp_path / 't.npz')
    real = _interrupting_save(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        tc.adagrad_optimize_resumable(n_iters, tobj, torch.as_tensor(INIT),
                                      checkpoint_path=path, **kw)
    monkeypatch.setattr(tc, 'save_checkpoint', real)
    assert int(tc.load_checkpoint_entry(path, 'i')) == 100
    resumed = tc.adagrad_optimize_resumable(
        n_iters, tobj, torch.as_tensor(INIT), checkpoint_path=path, **kw)
    assert int(tc.load_checkpoint_entry(path, 'i')) == n_iters
    for got, want in zip(resumed, jout):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=1e-13)
    whole = tc.adagrad_optimize_resumable(
        n_iters, tobj, torch.as_tensor(INIT),
        checkpoint_path=str(tmp_path / 'w.npz'), **kw)
    for got, want in zip(resumed, whole):
        assert (got is None and want is None) or torch.equal(got, want)
    plain = pt.adagrad_optimize(
        n_iters, tobj, torch.as_tensor(INIT), learning_rate=0.05,
        learning_rate_end=0.01, return_history=return_history,
        device='cpu', draws=draws)
    for k in (2, 3):
        assert torch.equal(resumed[k], plain[k])
    if return_history:
        assert torch.equal(resumed[1], plain[1])
        np.testing.assert_allclose(resumed[0].numpy(), plain[0].numpy(),
                                   rtol=1e-14)
    else:
        assert torch.equal(resumed[0], plain[0])


def test_resumable_generator_driven_equals_whole_run(tmp_path, monkeypatch):
    """An objective that samples inside its step draws iteration i from
    fold_in(seed, i): a resumed run equals the uninterrupted one and
    `adagrad_optimize` with the same generator."""
    _, tobj = _objectives(presampled=False)

    def gen():
        return torch.Generator().manual_seed(8)

    path = str(tmp_path / 'g.npz')
    real = _interrupting_save(monkeypatch, 1)
    with pytest.raises(KeyboardInterrupt):
        tc.adagrad_optimize_resumable(
            120, tobj, torch.as_tensor(INIT), checkpoint_path=path,
            generator=gen(), save_every=40, device='cpu')
    monkeypatch.setattr(tc, 'save_checkpoint', real)
    resumed = tc.adagrad_optimize_resumable(
        120, tobj, torch.as_tensor(INIT), checkpoint_path=path,
        generator=gen(), save_every=40, device='cpu')
    plain = pt.adagrad_optimize(120, tobj, torch.as_tensor(INIT),
                                generator=gen(), device='cpu')
    for k in (1, 2, 3):
        assert torch.equal(resumed[k], plain[k])


def test_resumable_wrong_mode_names_the_flag(tmp_path):
    _, tobj = _objectives()
    init = torch.as_tensor(INIT)
    kw = dict(save_every=50, device='cpu')
    path = str(tmp_path / 'mode.npz')
    tc.adagrad_optimize_resumable(100, tobj, init, checkpoint_path=path,
                                  **kw)
    with pytest.raises(ValueError, match='return_history=True.*'
                                         'return_history=False'):
        tc.adagrad_optimize_resumable(100, tobj, init, checkpoint_path=path,
                                      return_history=False, **kw)
    path2 = str(tmp_path / 'mode2.npz')
    tc.adagrad_optimize_resumable(100, tobj, init, checkpoint_path=path2,
                                  return_history=False, **kw)
    with pytest.raises(ValueError, match='return_history=False'):
        tc.adagrad_optimize_resumable(100, tobj, init, checkpoint_path=path2,
                                      **kw)


def test_resumable_rejects_changed_hyperparameters_and_seed(tmp_path):
    _, tobj = _objectives()
    init = torch.as_tensor(INIT)
    path = str(tmp_path / 'hp.npz')
    kw = dict(checkpoint_path=path, save_every=50, device='cpu')
    tc.adagrad_optimize_resumable(100, tobj, init, learning_rate=0.01, **kw)
    with pytest.raises(ValueError, match='learning_rate'):
        tc.adagrad_optimize_resumable(100, tobj, init, learning_rate=0.05,
                                      **kw)
    with pytest.raises(ValueError, match='learning_rate_end'):
        tc.adagrad_optimize_resumable(100, tobj, init, learning_rate=0.01,
                                      learning_rate_end=0.001, **kw)
    with pytest.raises(ValueError, match='different PRNG key'):
        tc.adagrad_optimize_resumable(
            100, tobj, init, learning_rate=0.01,
            generator=torch.Generator().manual_seed(1), **kw)
    with pytest.raises(ValueError, match='n_iters, window'):
        tc.adagrad_optimize_resumable(120, tobj, init, learning_rate=0.01,
                                      **kw)
    # the original values resume fine (a completed run: nothing to do)
    tc.adagrad_optimize_resumable(100, tobj, init, learning_rate=0.01, **kw)


def test_chains_reject_changed_hyperparameters_kind_and_seed(tmp_path):
    _, tobj = _objectives()
    init = torch.as_tensor(INIT)
    path = str(tmp_path / 'hp_chains.npz')
    kw = dict(n_optimisers=2, rhat_window=20, tail_avg_iters=20,
              checkpoint_path=path, save_every=30, device='cpu')
    pt.rmsprop_IA_optimize_with_rhat(60, tobj, init, 2, learning_rate=0.01,
                                     **kw)
    with pytest.raises(ValueError, match='learning_rate'):
        pt.rmsprop_IA_optimize_with_rhat(60, tobj, init, 2,
                                         learning_rate=0.02, **kw)
    with pytest.raises(ValueError, match='kind'):
        pt.adam_IA_optimize_with_rhat(60, tobj, init, 2, learning_rate=0.01,
                                      **kw)
    with pytest.raises(ValueError, match='different PRNG key'):
        pt.rmsprop_IA_optimize_with_rhat(
            60, tobj, init, 2, learning_rate=0.01,
            generator=torch.Generator().manual_seed(4), **kw)


def test_unknown_format_is_refused_and_legacy_names_are_read(tmp_path):
    path = str(tmp_path / 'future.npz')
    tc.save_checkpoint(path, {'format': np.asarray('adagrad-history/v9'),
                              'i': np.int64(0)})
    with pytest.raises(ValueError, match='does not know'):
        tc.checkpoint_format(path)
    legacy = str(tmp_path / 'legacy.npz')
    tc.save_checkpoint(legacy, {'i': np.int64(0), 'params': np.zeros(2)})
    assert tc.checkpoint_format(legacy) == jc.checkpoint_format(legacy) \
        == 'adagrad-history/v1'
    shutil.copy(legacy, str(tmp_path / 'copy.npz'))
    assert tc.checkpoint_format(str(tmp_path / 'copy.npz')) \
        == 'adagrad-history/v1'
