"""The reference against the program on the CPU at small sizes: the
pieces (densities, gradients, draws, PSIS) and whole runs of each cell,
which read within every limit."""
import math
import warnings

import numpy as np
import pytest
import torch

import viabel_tpu_torch as vt
from viabel_tpu_torch.models import (eight_schools_cp_model,
                                     linear_regression_model)

from viabel_tpu_torch.ops.philox import philox_normal_plain, philox_seed
from viabel_tpu_torch.optimizers import _perturbed_inits

from portbench import correct
from portbench.reference import (eight_schools_cp_mft40 as es,
                                 large_d300_fullrank as ld, philox, psis, vi)
from portbench.run import Cell, load_json

from .cpu_sizes import SMALL, manifest, run_small

ES_CFG = load_json('configs', 'eight_schools_cp_mft40.json')
LD_CFG = load_json('configs', 'large_d300_fullrank.json')


def _autograd(f, x):
    x = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(f(x).sum(), x)
    return g


def test_eight_schools_density_and_gradient():
    x = torch.randn(50, 10, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    target = es.Target(ES_CFG, torch.float64, 'cpu')
    model = eight_schools_cp_model()
    torch.testing.assert_close(target.log_p(x), model.log_prob(x),
                               rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(target.grad(x), _autograd(target.log_p, x),
                               rtol=1e-10, atol=1e-10)


def test_regression_density_and_gradient():
    X, Y = ld.data(LD_CFG)
    model = linear_regression_model(X, Y, noise_scale=0.5, prior_std=3.0)
    target = ld.Target(LD_CFG, torch.float64, 'cpu')
    x = 0.1 * torch.randn(6, 300, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(target.log_p(x), model.log_prob(x),
                               rtol=1e-10, atol=1e-6)
    torch.testing.assert_close(target.grad(x), _autograd(target.log_p, x),
                               rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize('family', ['mf_t', 'full_rank'])
def test_draws_and_log_q(family):
    g = lambda: torch.Generator().manual_seed(7)
    if family == 'mf_t':
        ref, port = vi.MeanFieldT(10, 40), \
            vt.mean_field_t_variational_family(10, 40)
        p = torch.randn(20, dtype=torch.float64) * 0.3
    else:
        ref, port = vi.FullRankGaussian(5), \
            vt.full_rank_gaussian_variational_family(5)
        p = torch.randn(20, dtype=torch.float64) * 0.3
    z_ref = ref.draws(g(), 1000, torch.float64, 'cpu').double()
    z_port = port.base_sample(g(), 1000, torch.float32).double()
    torch.testing.assert_close(z_ref, z_port, rtol=1e-6, atol=1e-6)
    x = ref.transform(p, z_ref)
    torch.testing.assert_close(x, port.transform(p, z_ref), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(ref.log_q(p, x), port.log_prob(p, x),
                               rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(ref.cov(p), port.mean_and_cov(p)[1],
                               rtol=1e-12, atol=1e-12)
    c2, c4 = ref.moments(p)
    assert c2 == pytest.approx(float(port.pth_moment(p, 2)), rel=1e-12)
    assert c4 == pytest.approx(float(port.pth_moment(p, 4)), rel=1e-12)


@pytest.mark.parametrize('seed', [0, 2 ** 63 + 12345, 2 ** 64 - 1])
def test_philox_stream_against_the_port(seed):
    got = philox.normal(300, 10, seed)
    want = philox_normal_plain(300, 10, seed, dtype=torch.float64)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)


def test_perturbed_starts_against_the_port():
    ref = Cell(manifest(), 'es_cp_multistart8', 'cpu',
               SMALL['es_cp_multistart8']).reference()
    init = torch.linspace(-1.0, 1.0, 20, dtype=torch.float64)
    g = lambda: torch.Generator().manual_seed(2 ** 40 + 3)
    got = ref.inits(g(), init, 8, 0.5)
    noise = philox_normal_plain(8, 20, philox_seed(g()),
                                dtype=torch.float64)
    torch.testing.assert_close(got, _perturbed_inits(init, 8, 0.5, noise),
                               rtol=1e-12, atol=1e-12)


def test_a_start_float32_cannot_follow_is_excused():
    """At a scale that sends starts out of float32's reach, a start whose
    float32 replay fails the limits against the float64 reference is
    excused, the others compared; a NaN put in a start that the replay
    follows fails."""
    c = Cell(manifest(), 'es_cp_multistart8', 'cpu',
             SMALL['es_cp_multistart8'])
    c.loop.mix = dict(c.mix, perturb_scale=0.5)
    seed = 2 ** 33 + 5
    limits = load_json('limits', 'es_cp_multistart8.json')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = c.loop.call(seed)
        refs = c.loop.check(c.reference(), seed, out)
    excused = [correct.excused(r, limits) for r in refs]
    finite = [bool(torch.isfinite(o['param']).all()) for o in out]
    assert not excused[0] and any(excused) and not all(finite)
    assert all(f or e for f, e in zip(finite, excused))
    assert not correct.judge(correct.worst(zip(out, refs)), limits)[0]
    assert correct.judge(correct.worst(zip(out, refs), limits), limits)[0]
    out[0] = dict(out[0], param=out[0]['param'] * float('nan'))
    assert not correct.judge(correct.worst(zip(out, refs), limits),
                             limits)[0]


@pytest.mark.parametrize('first', [0, 1])
def test_a_nan_anywhere_stays_nan(first):
    def result(v):
        return dict(param=torch.full((3,), v), d2=v, W2=v, khat=v,
                    psis_mean=torch.full((3,), v), q_scale=1.0)
    ref = result(1.0)
    pairs = [(result(1.0), ref), (result(1.0), ref)]
    pairs[first] = (result(float('nan')), ref)
    assert all(math.isnan(v) for v in correct.worst(pairs).values())


@pytest.mark.parametrize('n', [20000, 300])
def test_psis_against_the_port(n):
    lw = torch.distributions.StudentT(3.0).sample(
        (n,)).double() * 2.0 - 30.0
    slw, khat = psis.psislw(lw)
    slw_p, khat_p = vt.psislw(lw)
    assert khat == pytest.approx(float(khat_p), abs=1e-10)
    torch.testing.assert_close(slw, slw_p, rtol=1e-10, atol=1e-10)


def test_bounds_against_the_port():
    lw = torch.randn(50000, dtype=torch.float64) - 3.0
    p = torch.randn(20, dtype=torch.float64) * 0.3
    fam = vt.mean_field_t_variational_family(10, 40)
    q_cov = fam.mean_and_cov(p)[1].numpy()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = vt.all_bounds(lw, q_var=q_cov,
                             moment_bound_fn=vt.family_moment_bounds(fam, p))
    c2, c4 = vi.MeanFieldT(10, 40).moments(p)
    got = vi.bounds(vi.lw_stats(lw), c2, c4, q_cov)
    for k in ('d2', 'W1', 'W2', 'mean_error', 'std_error'):
        assert got[k] == pytest.approx(want[k], rel=1e-10), k
    np.testing.assert_allclose(got['cov_error'], want['cov_error'],
                               rtol=1e-10)


@pytest.mark.parametrize('cell', sorted(SMALL))
def test_whole_run_on_the_cpu(cell):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        result = run_small(cell)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'
    assert result['attempted'] >= 1 and result['failed'] == 0
