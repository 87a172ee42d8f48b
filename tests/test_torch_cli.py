"""The port's config layer and command line against the JAX package's
(viabel_tpu.config, ``python -m viabel_tpu``), on the CPU.

`configs` prints the same JSON; a config written by either package runs in
the other; `build` gives equal objective values on shared draws for every
model, family and objective (float64); ``run`` prints the JAX package's
labels, without its ``mesh:`` lines, for the plain, ``--no-presampled``,
``--fused``, IA, checkpoint, ``--starts`` and ``--sweep-lr`` runs, and its
validation exits with the JAX package's messages
(tests/test_cli_serve.py:13-139, 531-760).
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viabel_tpu import config as jcfg
from viabel_tpu.__main__ import main as jmain
from viabel_tpu_torch import config as tcfg
from viabel_tpu_torch import interop
from viabel_tpu_torch.__main__ import main as tmain

CPU = ['--device', 'cpu']


def test_registries_and_defaults_match_jax():
    for name in ('MODELS', 'FAMILIES', 'OBJECTIVES', 'OPTIMIZERS'):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    assert tcfg.ExperimentConfig().to_json() == \
        jcfg.ExperimentConfig().to_json()
    for bad in (dict(model='nope'), dict(family='nope'),
                dict(objective='nope'), dict(optimizer='nope')):
        with pytest.raises(ValueError) as t_err:
            tcfg.ExperimentConfig(**bad)
        with pytest.raises(ValueError) as j_err:
            jcfg.ExperimentConfig(**bad)
        assert str(t_err.value) == str(j_err.value)


def test_configs_prints_the_jax_json(capsys):
    jmain(['configs'])
    want = capsys.readouterr().out
    tmain(['configs'])
    assert capsys.readouterr().out == want


def test_config_written_by_one_package_runs_in_the_other(tmp_path, capsys):
    fields = dict(model='funnel', n_iters=120, n_mc=10, bound_samples=3000,
                  learning_rate=0.02, seed=3)
    jpath, tpath = tmp_path / 'j.json', tmp_path / 't.json'
    jpath.write_text(jcfg.ExperimentConfig(**fields).to_json())
    tpath.write_text(tcfg.ExperimentConfig(**fields).to_json())
    assert jpath.read_text() == tpath.read_text()
    assert tcfg.ExperimentConfig.from_json(jpath.read_text()) == \
        tcfg.ExperimentConfig(**fields)
    tmain(['run', '--config', str(jpath), '--quiet'] + CPU)
    t_out = capsys.readouterr().out
    jmain(['run', '--config', str(tpath), '--quiet'])
    j_out = capsys.readouterr().out
    assert '"learning_rate": 0.02' in t_out and 'khat' in t_out
    assert _labels(t_out) == _labels(j_out)


MODELS = ('funnel', 'normal_mixture', 'robust_regression',
          'eight_schools_cp', 'eight_schools_ncp', 'linear_regression')
FAMILIES = ('mean_field_gaussian', 'mean_field_t', 'full_rank_gaussian',
            'full_rank_t')


@pytest.mark.parametrize('family', FAMILIES)
@pytest.mark.parametrize('model', MODELS)
def test_build_gives_equal_objectives(model, family):
    """Every objective of the config at a nonzero parameter, on the JAX
    package's base draws: equal values and gradients (float64)."""
    for objective in tcfg.OBJECTIVES:
        cfg = dict(model=model, family=family, objective=objective, n_mc=8,
                   df=7.0)
        jm, jf, jo = jcfg.build(jcfg.ExperimentConfig(**cfg))
        tm, tf, to = tcfg.build(tcfg.ExperimentConfig(**cfg))
        assert (tm.dim, tf.var_param_dim, to.presampled) == \
            (jm.dim, jf.var_param_dim, True)
        param = np.random.RandomState(1).randn(jf.var_param_dim) * 0.1
        draws = jf.base_sample(jax.random.PRNGKey(2), 8, jnp.float64)
        host = ({k: np.asarray(v) for k, v in draws.items()}
                if isinstance(draws, dict) else np.asarray(draws))
        j_out = jo(jnp.asarray(param), draws)
        t_out = to(torch.as_tensor(param), interop.base_draws(host))
        for got, want in zip(t_out[:2], j_out[:2]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-8, atol=1e-10,
                                       err_msg=objective)


def test_build_without_presampling_samples_from_a_generator():
    _, tf, to = tcfg.build(tcfg.ExperimentConfig(model='funnel',
                                                 presampled=False, n_mc=10))
    assert not getattr(to, 'presampled', False)
    value, _ = to(tf.init_param(torch.float64),
                  torch.Generator().manual_seed(0))
    assert np.isfinite(float(value))
    with pytest.raises(TypeError, match='presampled'):
        _, f, o = tcfg.build(tcfg.ExperimentConfig(model='funnel', n_mc=10))
        o(f.init_param(), torch.Generator().manual_seed(0))


_NUMBER = re.compile(r'[-+]?(\d+\.?\d*|\.\d+)(e[-+]?\d+)?|nan|inf')


def _labels(out):
    """Each printed line with its numbers (and the unreliable-khat note,
    which depends on the draws) taken out, the JAX package's mesh and
    progress lines dropped."""
    lines = []
    for line in out.splitlines():
        if line.startswith(('mesh:', 'note:')) or '\r' in line:
            continue
        line = line.replace('  (> 0.7: unreliable)', '')
        line = re.sub(r'"checkpoint_path": ".*"', '"checkpoint_path": #',
                      line)
        line = ' '.join(_NUMBER.sub('#', line).split())
        lines.append(re.sub(r'\[ | \]', lambda m: m.group().strip(), line))
    return lines


RUNS = {
    'plain': ['--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
              '--bound-samples', '5000', '--quiet'],
    'no-presampled': ['--model', 'funnel', '--n-iters', '200', '--n-mc',
                      '10', '--bound-samples', '5000', '--quiet',
                      '--no-presampled'],
    'fused': ['--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
              '--bound-samples', '5000', '--fused'],
    'ia': ['--model', 'linear_regression', '--family', 'mean_field_gaussian',
           '--optimizer', 'rmsprop_ia', '--n-chains', '2', '--n-iters',
           '300', '--n-mc', '20', '--bound-samples', '5000', '--quiet'],
    'mixture': ['--model', 'normal_mixture', '--n-iters', '150', '--n-mc',
                '10', '--bound-samples', '4000', '--quiet'],
    'starts': ['--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
               '--bound-samples', '4000', '--starts', '3',
               '--perturb-scale', '0.1'],
    'sweep': ['--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
              '--bound-samples', '4000', '--sweep-lr', '0.1,0.01',
              '--learning-rate-end', '0.001'],
}


@pytest.mark.parametrize('name', sorted(RUNS))
def test_run_prints_the_jax_labels(name, capsys):
    tmain(['run'] + RUNS[name] + CPU)
    t_out = capsys.readouterr().out
    jmain(['run'] + RUNS[name])
    j_out = capsys.readouterr().out
    assert 'mesh:' not in t_out
    assert _labels(t_out) == _labels(j_out)
    khat = re.findall(r'khat = ([-+]?[\d.]+|nan|inf)', t_out)
    assert khat and all(np.isfinite(float(k)) for k in khat)


def test_run_plain_progress_lines(capsys):
    tmain(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
           '--bound-samples', '2000'] + CPU)
    out = capsys.readouterr().out
    assert out.count('\r  iter ') == 101  # every 2nd iteration and the last
    assert '\r  iter     200/200 | loss = ' in out


@pytest.mark.parametrize('optimizer', ['adagrad', 'rmsprop_ia'])
def test_run_with_checkpoint_resumes(tmp_path, capsys, optimizer):
    from viabel_tpu_torch.checkpoint import (checkpoint_format,
                                             load_checkpoint_entry)
    path = str(tmp_path / 'cli_ckpt.npz')
    args = ['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
            '--bound-samples', '2000', '--optimizer', optimizer,
            '--checkpoint-path', path, '--quiet'] + CPU
    tmain(args)
    first = capsys.readouterr().out
    assert load_checkpoint_entry(path, 'params').shape[-1] == 4
    assert checkpoint_format(path) == ('adagrad-history/v1'
                                       if optimizer == 'adagrad'
                                       else 'chains/v1')
    tmain(args)  # a completed checkpoint: the same fit again
    assert capsys.readouterr().out == first
    jpath = str(tmp_path / 'jax_ckpt.npz')
    jmain(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
           '--bound-samples', '2000', '--optimizer', optimizer,
           '--checkpoint-path', jpath, '--quiet'])
    j_out = capsys.readouterr().out
    assert _labels(first.replace(path, '#')) == \
        _labels(j_out.replace(jpath, '#'))


INVALID = [
    (['--bound-samples', '0', '--fused'], 'bound-samples'),
    (['--checkpoint-path', '/tmp/x.npz', '--fused'], 'checkpoint'),
    (['--optimizer', 'adam_ia', '--fused'], 'adagrad optimizer only'),
    (['--starts', '2', '--sweep-lr', '0.1,0.01'], 'mutually exclusive'),
    (['--optimizer', 'adam_ia', '--starts', '2'], 'adagrad'),
    (['--starts', '2', '--checkpoint-path', '/tmp/x.npz'], 'checkpoint'),
    (['--starts', '2', '--bound-samples', '0'], 'bound-samples'),
    (['--starts', '-2'], 'positive'),
    (['--starts', '0'], 'positive'),
    (['--sweep-lr', '0.1,0.01', '--sweep-lr-end', '0.001'],
     'one end rate per'),
    (['--sweep-lr', ','], 'empty list'),
    (['--sweep-lr', '0.1,x'], 'comma-separated list of rates'),
    (['--sweep-lr', '0.1,0.001', '--learning-rate-end', '0.001'],
     '0 < end < rate'),
]


@pytest.mark.parametrize('extra,match', INVALID)
def test_validation_exits_with_the_jax_messages(extra, match):
    base = ['run', '--model', 'funnel', '--n-iters', '100']
    with pytest.raises(SystemExit, match=re.escape(match)) as t_exit:
        tmain(base + extra + CPU)
    with pytest.raises(SystemExit) as j_exit:
        jmain(base + extra)
    assert str(t_exit.value) == str(j_exit.value)


def test_bench_exits_with_its_message():
    """`bench` runs the port's benchmark (tests/test_torch_bench.py runs it
    on the CPU); without a card, and without ``--device cpu``, it exits
    with run's message."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(SystemExit, match='--device cpu'):
        tmain(['bench'])


def test_run_needs_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(SystemExit, match='--device cpu'):
        tmain(['run', '--n-iters', '10', '--bound-samples', '100'])


def test_fit_dispatch_and_first_chain_average():
    """config.fit: adagrad returns the smoothed parameter; IA returns the
    first chain's final mean and sigma averages and the optimisation log;
    the default generator is the first of the seed's 3-way split."""
    from viabel_tpu_torch.experiments import _split
    from viabel_tpu_torch.optimizers import rmsprop_IA_optimize_with_rhat
    cfg = tcfg.ExperimentConfig(model='funnel', n_iters=60, n_mc=10,
                                optimizer='rmsprop_ia', n_chains=2, seed=5)
    model, family, objective = tcfg.build(cfg)
    param, values, log = tcfg.fit(cfg, model, family, objective,
                                  device='cpu')
    out = rmsprop_IA_optimize_with_rhat(
        60, objective, family.init_param(), 2,
        generator=_split(torch.Generator().manual_seed(5), 3)[0],
        n_optimisers=2, device='cpu')
    np.testing.assert_array_equal(
        param.numpy(), np.concatenate([out[2][0][-1], out[3][0][-1]]))
    np.testing.assert_array_equal(values, out[4])
    assert log['start_avg_mean_iters'] == out[6]['start_avg_mean_iters']
    cfg = tcfg.ExperimentConfig(model='funnel', n_iters=60, n_mc=10)
    model, family, objective = tcfg.build(cfg)
    param, values, log = tcfg.fit(cfg, model, family, objective,
                                  device='cpu')
    assert log is None and param.shape == (4,) and values.shape == (60,)
    assert json.loads(cfg.to_json())['optimizer'] == 'adagrad'
