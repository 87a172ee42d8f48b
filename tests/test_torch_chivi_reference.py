"""The port's CHIVI against the benchmark's plain CHIVI reference
(`portbench/reference/chivi.py`), float64 on the CPU, with no JAX.

The reference is written from CHIVI's definition (the closed-form
reparameterisation gradient of a location-scale family) and the
min-rescaled adagrad window; the port takes the gradient as a
`torch.func.vjp` of its log-weights and runs the window in its step
kernel's plain version.  Both sides take the same float64 draws, so what
is left between them is the order of float64 operations.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import viabel_tpu_torch as vt
from viabel_tpu_torch.models import eight_schools_cp_model

from portbench.correct import gaps
from portbench.reference import chivi, vi
from portbench.reference import eight_schools_cp_chivi as es
from portbench.reference.protocols import Reference
from portbench.run import load_json

CFG = load_json('configs', 'eight_schools_cp_chivi.json')
F64 = torch.float64
# a small validated fit: CHIVI at n_mc 50, 300 iterations, 20000 bound
# samples; window, rates, alpha and init as the configuration's
SMALL = dict(CFG, n_mc=50, n_iters=300, n_bound_samples=20000)
# one evaluation: the port's vjp and the closed form sum the same float64
# terms in another order; the value and log-norm agree bit for bit, the
# gradient to 2e-14 relative and 9e-13 on an entry near zero
TOL_STEP = 1e-11
# a run feeds its own rounding back for hundreds of steps, and the CUBO's
# weights exp(2 (lw - max lw)) double a log-weight's error: the fit's gaps
# measured 1e-16 (param) to 5e-13 (W2, which exp(d2 / 4) amplifies), so
# 1e-9 leaves 2000x of room and stays far under the 1.2e-3 that dropping
# the log-norm moves the parameters by
TOL_RUN = 1e-9


def _port_family():
    return vt.mean_field_t_variational_family(CFG['dim'], CFG['df'])


class _ProgramDraws(vi.MeanFieldT):
    """The reference's family with the program's float64 draws: the
    reference's own draws follow the program's float32 stream (the
    benchmark's case), which a float64 program does not draw."""

    def draws(self, gen, n, work, device):
        return _port_family().base_sample(gen, n, work).to(device)


def _reference(cfg):
    module = SimpleNamespace(
        family=lambda cfg: _ProgramDraws(cfg['dim'], cfg['df']),
        Target=es.Target)
    return Reference(module, cfg, work=F64, device='cpu', opt_device='cpu')


def _init():
    return torch.as_tensor(es.init(CFG))


def test_init_is_the_moments_start():
    """The configuration's 20 init numbers are what it says they are:
    `init_from_moments` of the mean-field t(40) family on the CP model's
    HMC moments, to float64's rounding of one copy through JSON."""
    m = eight_schools_cp_model()
    want = vt.init_from_moments(
        _port_family(), torch.as_tensor(m.true_mean, dtype=F64),
        torch.as_tensor(m.true_cov, dtype=F64))
    torch.testing.assert_close(_init(), want.to(F64), rtol=0, atol=1e-12)


@pytest.mark.parametrize('alpha', [2, 3])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_value_gradient_and_log_norm(seed, alpha):
    g = torch.Generator().manual_seed(seed)
    p = _init() + 0.3 * torch.randn(20, dtype=F64, generator=g)
    t = _port_family().base_sample(g, 500, F64)
    obj = vt.black_box_chivi(alpha, _port_family(), eight_schools_cp_model(),
                             500, presampled=True)
    target = es.Target(CFG, F64, 'cpu')
    want = chivi.value_grad_and_log_norm(vi.MeanFieldT(10, 40), p, t,
                                         target.log_p, target.grad, alpha)
    for got, ref in zip(obj(p, t), want):
        torch.testing.assert_close(got, ref, rtol=TOL_STEP, atol=TOL_STEP)


def test_log_norm_rescaled_adagrad_run():
    n_iters, n_mc = 300, 100
    fam = _port_family()
    obj = vt.black_box_chivi(2, fam, eight_schools_cp_model(), n_mc,
                             presampled=True)
    draws = obj.make_draws(torch.Generator().manual_seed(4), n_iters, F64)
    param, _, _, log_norms = vt.adagrad_optimize(
        n_iters, obj, _init(), draws=draws, window=10, learning_rate=0.01,
        learning_rate_end=0.001, epsilon=0.1, device='cpu')
    target = es.Target(CFG, F64, 'cpu')

    def step(p, i):
        _, grad, log_norm = chivi.value_grad_and_log_norm(
            vi.MeanFieldT(10, 40), p, draws[i], target.log_p, target.grad, 2)
        return grad, log_norm

    want, want_log_norms = chivi.adagrad(
        step, _init(), vi.learning_rates(n_iters, 0.01, 0.001), 10, 0.1)
    torch.testing.assert_close(param, want, rtol=TOL_RUN, atol=0.0)
    torch.testing.assert_close(log_norms, want_log_norms, rtol=TOL_RUN,
                               atol=0.0)


@pytest.fixture(scope='module', params=[None, False],
                ids=['log_norm_on', 'log_norm_dropped'])
def fits(request, seed=2 ** 33 + 7):
    """``(has_log_norm, out, prog, ref)``: the port's small validated CHIVI
    fit (``has_log_norm`` as given to `validated_vi`: its default, on for
    CHIVI, or dropped), its numbers as `correct` reads them, and the
    reference's fit, from generators of one seed."""
    has_log_norm = request.param
    fam = _port_family()
    obj = vt.black_box_chivi(SMALL['alpha'], fam, eight_schools_cp_model(),
                             SMALL['n_mc'], presampled=True)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = vt.validated_vi(
            eight_schools_cp_model(), fam, _init(), SMALL['n_iters'],
            objective_and_grad=obj, n_bound_samples=SMALL['n_bound_samples'],
            has_log_norm=has_log_norm, window=SMALL['window'],
            learning_rate=SMALL['learning_rate'],
            learning_rate_end=SMALL['learning_rate_end'],
            epsilon=SMALL['epsilon'],
            generator=torch.Generator().manual_seed(seed), device='cpu')
    prog = dict(param=out['opt_param'], d2=out['bounds']['d2'],
                W2=out['bounds']['W2'], khat=out['khat'],
                psis_mean=out['psis_mean'])
    return has_log_norm, out, prog, chivi.fit(_reference(SMALL), seed,
                                              _init())


def test_validated_fit(fits):
    """The default (the log-norm on, as CHIVI asks) follows the reference
    on every number `correct` compares; the same fit with the log-norm
    dropped misses it on the fitted parameters by far more than the
    tolerance, so the rescaling is seen."""
    has_log_norm, out, prog, ref = fits
    got = gaps(prog, ref)
    if has_log_norm is None:
        assert all(v <= TOL_RUN for v in got.values()), got
        np.testing.assert_allclose(out['log_norm_history'].numpy(),
                                   ref['log_norms'].numpy(), rtol=TOL_RUN)
    else:
        assert got['param'] > 1e3 * TOL_RUN, got


def test_log_norm_history(fits):
    """A CHIVI fit records each iteration's max log-weight, none of them 0;
    with the log-norm dropped the step takes (and records) 0."""
    has_log_norm, out = fits[:2]
    history = out['log_norm_history']
    assert history.shape == (SMALL['n_iters'],)
    if has_log_norm is None:
        assert bool(torch.all(history != 0))
    else:
        assert bool(torch.all(history == 0))
