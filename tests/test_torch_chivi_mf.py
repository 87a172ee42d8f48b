"""The CHIVI value-and-gradient kernel of the mean-field families on the
eight-schools densities (`ops.chivi_mf`): the closed form it computes, the
rule that decides where it runs, the log-norm the adagrad runs take from
it, and, on the card, the kernel itself.

On the CPU: a float64 NumPy version of the CHIVI value, gradient and
log-norm of both mean-field families on the centred and non-centred
densities (the densities' own derivation is `test_torch_klvi_mf.py`'s),
held against the port's autograd objective (the kernel's plain version)
and the JAX package's ``black_box_chivi`` at 1e-12 relative; the dispatch
rule, case by case; the plain version's rows; and the adagrad runs on a
stand-in body that evaluates the plain version where the kernel would,
against the autograd runs, with and without the log-norm.

On the card (marker ``cuda``; the JAX package is imported inside the
fixture that uses it, so these run where only PyTorch is installed:
``python -m pytest tests/test_torch_chivi_mf.py -m cuda -q --noconftest``):
the kernel against its plain version in float64 (the kernel's float64
within 1e-12, its float32 within 1e-5 relative) at n_mc 100, 500 and 700
(past a float32 block's 512 threads; float64 strides past 256),
graph-driven fits on the kernel against the eager autograd run
(300 iterations, with the log-norm and without), the launch counts, and
`validated_vi` and a multistart batch engaging it.
"""
import math

import numpy as np
import pytest
import torch
from test_torch_klvi_mf import DF, SIGMA, Y, _inputs, np_cp, np_ncp, rel

import viabel_tpu_torch as pt
from viabel_tpu_torch.models import eight_schools_cp_model as tcp
from viabel_tpu_torch.models import eight_schools_ncp_model as tncp
from viabel_tpu_torch.ops import _launch
from viabel_tpu_torch.ops import adagrad as aops
from viabel_tpu_torch.ops import chivi_mf as cops
from viabel_tpu_torch.ops import mf_kernels
from viabel_tpu_torch.optimizers import (_adagrad_run, _adagrad_runs,
                                         _advance, _batched_objective,
                                         _batched_step,
                                         _iteration_objective,
                                         _learning_rates, _wrap_objective)

D, N_MC, ALPHA = 10, 100, 2
FAMILIES = ('mf_t', 'mf_gaussian')
MODELS = ('cp', 'ncp')
WINDOW, LR, LR_END, EPS = 10, 0.01, 0.001, 0.1


# --------------------------------------------------------------------------
# the derivation, in float64 NumPy
# --------------------------------------------------------------------------

def np_log_q(family, param, t):
    """log q(z) at z = mean + exp(log_scale) t, along the path: sum_j log
    t_df(t_j) - sum log_scale for the t family, sum_j log N(t_j; 0, 1) -
    sum log_std for the Gaussian."""
    if family == 'mf_t':
        lognorm = (math.lgamma(0.5 * (DF + 1)) - math.lgamma(0.5 * DF)
                   - 0.5 * math.log(DF * math.pi))
        base = np.sum(lognorm - 0.5 * (DF + 1) * np.log1p(t ** 2 / DF),
                      axis=1)
    else:
        base = np.sum(-0.5 * t ** 2 - 0.5 * math.log(2 * math.pi), axis=1)
    return base - np.sum(param[D:])


def np_chivi(family, model, param, t, alpha=ALPHA):
    """CHIVI at `param` = [mean, log_scale] on base draws t (n, d), with
    lw = log p(z) - log q(z), z = mean + s t, s = exp(log_scale), g the
    gradient of log p at z:
      log_norm = max lw,  w = exp(alpha (lw - log_norm))
      value    = log(mean w) / alpha + log_norm
      grad_m   = alpha / n sum w g
      grad_ls  = alpha / n (s sum w g t + sum w)
    (along the path log q moves with the log-scales alone, by -1 each)."""
    m, s = param[:D], param[D:]
    lp, g = (np_cp if model == 'cp' else np_ncp)(m + np.exp(s) * t)
    lw = lp - np_log_q(family, param, t)
    log_norm = np.max(lw)
    w = np.exp(alpha * (lw - log_norm))
    n = len(t)
    value = np.log(np.mean(w)) / alpha + log_norm
    grad = np.concatenate([alpha / n * (w @ g),
                           alpha / n * (np.exp(s) * (w @ (g * t))
                                        + np.sum(w))])
    return value, grad, log_norm


def _family(family):
    return (pt.mean_field_t_variational_family(D, DF) if family == 'mf_t'
            else pt.mean_field_gaussian_variational_family(D))


def _port(family, model, n_mc=N_MC):
    fam = _family(family)
    target = tcp() if model == 'cp' else tncp()
    return pt.black_box_chivi(ALPHA, fam, target, n_mc, presampled=True)


@pytest.fixture(scope='module')
def jx():
    """The JAX package's families, models and CHIVI, on the CPU at x64."""
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    import viabel_tpu as vt
    from viabel_tpu.models import (eight_schools_cp_model,
                                   eight_schools_ncp_model)
    return jnp, vt, eight_schools_cp_model, eight_schools_ncp_model


@pytest.mark.parametrize('runs', ['single', 'K8'])
@pytest.mark.parametrize('model', MODELS)
@pytest.mark.parametrize('family', FAMILIES)
def test_closed_form_chivi_matches_autograd_and_jax(jx, family, model, runs):
    """The NumPy CHIVI value, gradient and log-norm against the port's
    autograd objective (`ops.chivi_mf.chivi_mf_plain` on the counter's row,
    vmapped over a batch) and the JAX package's ``black_box_chivi`` on the
    same draws, 1e-12 relative."""
    jnp, vt, jcp, jncp = jx
    K = 1 if runs == 'single' else 8
    params, draws = _inputs(family, K, seed=4 + K)
    counter = np.arange(K) % draws.shape[1]
    obj = _port(family, model)
    jfam = (vt.mean_field_t_variational_family(D, DF) if family == 'mf_t'
            else vt.mean_field_gaussian_variational_family(D))
    jmodel = jcp() if model == 'cp' else jncp()
    jobj = vt.black_box_chivi(ALPHA, jfam, jmodel.log_prob, N_MC,
                              presampled=True)
    if runs == 'single':
        out = cops.chivi_mf_plain(obj, torch.tensor(params[0]),
                                  torch.tensor(draws[0]),
                                  torch.tensor(counter[:1]))
        out = [o[None] for o in out]
    else:
        out = cops.chivi_mf_plain(obj, torch.tensor(params),
                                  torch.tensor(draws), torch.tensor(counter))
    tv, tg, tn = out
    for k in range(K):
        row = draws[k, counter[k]]
        nv, ng, nn = np_chivi(family, model, params[k], row)
        jv, jg, jn = jobj(jnp.asarray(params[k]), jnp.asarray(row))
        for got, want in ((tv[k], nv), (jv, nv), (tn[k], nn), (jn, nn)):
            assert abs(float(got) - want) <= 1e-12 * abs(want)
        assert rel(tg[k].numpy(), ng) < 1e-12
        assert rel(np.asarray(jg), ng) < 1e-12


# --------------------------------------------------------------------------
# the dispatch rule
# --------------------------------------------------------------------------

def _case(name):
    """An objective of each kind the rule must tell apart, and the entry
    point of the hand-written body it carries (None: the autograd body)."""
    from viabel_tpu_torch.models import (funnel_model,
                                         make_callback_log_density)
    mft, mfg = _family('mf_t'), _family('mf_gaussian')
    cp, ncp = tcp(), tncp()
    chivi = pt.black_box_chivi
    cases = {
        'mf_t_cp': (lambda: chivi(2, mft, cp, 20, True), 'chivi_mf'),
        'mf_t_ncp': (lambda: chivi(2, mft, ncp, 20, True),
                     'chivi_mf'),
        'mf_gaussian_cp': (lambda: chivi(2, mfg, cp, 20, True),
                           'chivi_mf'),
        'mf_gaussian_ncp': (lambda: chivi(2, mfg, ncp, 20, True),
                            'chivi_mf'),
        'alpha_1_5': (lambda: chivi(1.5, mft, cp, 20, True),
                      'chivi_mf'),
        'neff': (lambda: pt.black_box_chivi_neff(2, mft, cp, 20, True),
                 None),
        'not_presampled': (lambda: chivi(2, mft, cp, 20), None),
        'full_rank_gaussian': (lambda: chivi(
            2, pt.full_rank_gaussian_variational_family(D), cp, 20, True),
            None),
        'full_rank_t': (lambda: chivi(2, pt.t_variational_family(D, DF), cp,
                                      20, True), None),
        'funnel': (lambda: chivi(2, pt.mean_field_t_variational_family(
            2, DF), funnel_model(), 20, True), None),
        'schools_of_seven': (lambda: chivi(
            2, pt.mean_field_t_variational_family(9, DF),
            tcp(Y[:7], SIGMA[:7]), 20, True), None),
        'log_prob_not_model': (lambda: chivi(2, mft, cp.log_prob, 20, True),
                               None),
        'host_callback': (lambda: chivi(2, mft, make_callback_log_density(
            lambda x: np.zeros(len(x)), lambda x: np.zeros_like(x), D,
            batched=True), 20, True), None),
        'klvi': (lambda: pt.black_box_klvi(mft, cp, 20, True),
                 'klvi_mf'),
    }
    make, body = cases[name]
    return make(), body


DISPATCH_CASES = ('mf_t_cp', 'mf_t_ncp', 'mf_gaussian_cp', 'mf_gaussian_ncp',
                  'alpha_1_5', 'neff', 'not_presampled', 'full_rank_gaussian',
                  'full_rank_t', 'funnel', 'schools_of_seven',
                  'log_prob_not_model', 'host_callback', 'klvi')


@pytest.mark.parametrize('case', DISPATCH_CASES)
def test_dispatch_rule(case):
    """Presampled CHIVI without n_eff of a mean-field family on an
    eight-schools `Model` carries the CHIVI kernel's body, a KLVI objective
    there still the KLVI kernel's, anything else none; the wrapped and the
    batched adagrad objectives carry it on with the run's log-norm flag,
    the IA chains' step never; and on the CPU no body engages, so a CPU run
    keeps its autograd body."""
    obj, kind = _case(case)
    body = getattr(obj, 'fused', None)
    assert (body is None) == (kind is None)
    if body is not None:
        assert type(body) is mf_kernels.MeanFieldBody
        assert body.name == kind
        # the family rides in the first own argument: CHIVI's t flag,
        # KLVI's entropy constant (0 for the t family)
        assert (body.own[0] == (1 if kind == 'chivi_mf' else 0)) == (
            not case.startswith('mf_gaussian'))
        assert body.model.kernel in mf_kernels.MODELS
    for flag in (None, False):
        wrapped = _wrap_objective(obj, flag)
        assert wrapped.fused is body
        assert wrapped.has_log_norm is (obj.has_log_norm if flag is None
                                        else flag)
    if getattr(obj, 'presampled', False):
        assert _batched_objective(obj, None).fused is body
        assert _batched_objective(obj, None).has_log_norm is obj.has_log_norm
        assert getattr(_batched_step(obj, None), 'fused', None) is None
    if body is None:
        return
    state = aops.new_state(torch.zeros(2 * D, dtype=torch.float64),
                           _learning_rates(4, LR, None, torch.float64),
                           WINDOW, EPS, False)
    for dtype in (torch.float64, torch.float32, torch.float16):
        param = torch.zeros(2 * D, dtype=dtype)
        assert not body.engages(param, torch.zeros(4, 20, D, dtype=dtype))
    draws = torch.zeros(4, 20, D, dtype=torch.float64)
    _, fused = _iteration_objective(_wrap_objective(obj, None), state, draws)
    assert fused is None


@pytest.mark.parametrize('runs', ['single', 'K3'])
def test_plain_version_reads_the_counters_row(runs):
    """The plain version is the autograd CHIVI objective on row
    ``counter[k]`` of run k's block (row 0 without a counter)."""
    obj = _port('mf_t', 'cp', n_mc=7)
    K = 1 if runs == 'single' else 3
    rng = np.random.default_rng(5)
    params = torch.tensor(rng.normal(0, 0.5, (K, 2 * D)))
    block = torch.tensor(rng.standard_t(DF, (K, 4, 7, D)))
    if runs == 'single':
        params, block = params[0], block[0]
    counter = torch.full((K,), 2, dtype=torch.int64)
    for c in (counter, None):
        got = cops.chivi_mf_plain(obj, params, block, c)
        row = 2 if c is not None else 0
        for k in range(K):
            p = params[k] if runs == 'K3' else params
            rows = block[k] if runs == 'K3' else block
            want = obj(p, rows[row])
            for g, w in zip(got, want):
                g = g[k] if runs == 'K3' else g
                assert rel(g, w) < 1e-14


class _PlainBody:
    """A stand-in for CHIVI's `ops.mf_kernels.MeanFieldBody` that engages
    on the CPU: its ``bind`` evaluates the plain version on the counter's
    row, as the kernel would on the card, into buffers bound once a
    run."""

    def __init__(self, body):
        self.body = body

    def engages(self, param, draws):
        return True

    def bind(self, param, draws, counter):
        value = param.new_empty(param.shape[:-1])
        grad, log_norm = torch.empty_like(param), torch.empty_like(value)

        def evaluate():
            v, g, n = cops.chivi_mf_plain(self.body.objective, param, draws,
                                          counter)
            value.copy_(v)
            grad.copy_(g)
            log_norm.copy_(n)
            return value, grad, log_norm

        return evaluate


@pytest.mark.parametrize('log_norm', ['kept', 'off'])
@pytest.mark.parametrize('runs', ['single', 'K3'])
def test_runs_take_the_bodys_log_norm_where_they_keep_one(runs, log_norm):
    """Adagrad runs whose objective's body engages (a stand-in that runs
    the plain version on the CPU) end where the autograd runs end, bit for
    bit, 23 iterations past the window: the body's log-norm reaches the
    step's ring and history where the run keeps one (``has_log_norm``
    None, CHIVI's own True), and None (zeros) with ``has_log_norm=False``,
    as the autograd body gives."""
    n_iters = 33
    K = 1 if runs == 'single' else 3
    flag = None if log_norm == 'kept' else False
    obj = _port('mf_gaussian', 'ncp', n_mc=16)
    autograd = _port('mf_gaussian', 'ncp', n_mc=16)
    autograd.fused = None
    obj.fused = _PlainBody(obj.fused)
    params, _ = _inputs('mf_gaussian', K, seed=8)
    inits = torch.tensor(params * 0.1)
    g = torch.Generator().manual_seed(3)
    block = torch.stack([obj.make_draws(g, n_iters, torch.float64)
                         for _ in range(K)])
    lr = _learning_rates(n_iters, LR, LR_END, torch.float64)

    def run(o):
        if K == 1:
            return _adagrad_run(_wrap_objective(o, flag), n_iters, WINDOW,
                                LR, EPS, LR_END, inits[0], block[0],
                                keep_history=True)
        return _adagrad_runs(o, flag, n_iters, WINDOW, lr.repeat(K, 1), EPS,
                             inits, block, keep_history=True)

    got, want = run(obj), run(autograd)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    log_norms = got[1]
    if log_norm == 'kept':
        assert not torch.equal(log_norms, torch.zeros_like(log_norms))
    else:
        assert torch.equal(log_norms, torch.zeros_like(log_norms))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _card_inputs(family, K, n_mc, n_iters, dtype, device, seed):
    rng = np.random.default_rng(seed)
    params = np.concatenate([rng.normal(0.0, 2.0, (K, D)),
                             rng.normal(-0.5, 0.4, (K, D))], axis=1)
    params[:, 1] = rng.normal(1.0, 0.5, K)
    shape = (K, n_iters, n_mc, D)
    draws = (rng.standard_t(DF, shape) if family == 'mf_t'
             else rng.standard_normal(shape))
    return (torch.tensor(params, dtype=dtype, device=device),
            torch.tensor(draws, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize('n_mc', [100, 500, 700])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('runs', ['single', 'K8'])
@pytest.mark.parametrize('model', MODELS)
@pytest.mark.parametrize('family', FAMILIES)
def test_kernel_matches_plain(cuda, family, model, runs, dtype, n_mc):
    """The kernel's value, gradient and log-norm against its plain version
    (the autograd objective) in float64 on the same inputs and the
    counters' rows, 1e-12 relative in float64 and 1e-5 in float32, at n_mc
    100, 500 (the cell's) and 700 (a stride past float32's 512 threads,
    float64 strides past 256); one launch counted; the same outputs to the
    bit at a second launch; a counter past the block gives NaN.  (The
    float32 autograd objective is itself up to 1e-5 off float64: 9.9e-6
    on the gradient at n_mc 500 on the card, the kernel 6.4e-6.)"""
    K = 1 if runs == 'single' else 8
    p, block = _card_inputs(family, K, n_mc, 5, dtype, cuda, seed=11 + K)
    counter = torch.tensor(np.arange(K) % 5, device=cuda)
    if runs == 'single':
        p, block, counter = p[0], block[0], counter[:1].clone()
    obj = _port(family, model, n_mc)
    evaluate = obj.fused.bind(p, block, counter)
    before = _launch.launches['chivi_mf']
    outs = [o.clone() for o in evaluate()]
    assert _launch.launches['chivi_mf'] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(outs, evaluate()))
    want = cops.chivi_mf_plain(obj, p.double(), block.double(), counter)
    for got, w in zip(outs, want):
        got, w = got.reshape(K, -1).cpu(), w.reshape(K, -1).cpu()
        for k in range(K):
            assert rel(got[k], w[k]) < TOL[dtype], k
    counter.fill_(5)
    assert all(torch.isnan(o).all() for o in evaluate())


def _fit_pair(cuda, family, model, dtype, K, flag, n_iters=300):
    """The graph-driven fit on the kernel and the eager autograd run of the
    same objective on the same draws: ``(outs, (launches, replayed),
    autograd outs)``."""
    params, _ = _card_inputs(family, K, 1, 1, dtype, cuda, seed=21)
    inits = params * 0.1
    obj = _port(family, model, 500)
    autograd = _port(family, model, 500)
    autograd.fused = None
    g = torch.Generator(device=cuda).manual_seed(7)
    blocks = [obj.make_draws(g, n_iters, dtype) for _ in range(K)]
    lr = _learning_rates(n_iters, LR, LR_END, dtype).repeat(K, 1)
    block = torch.stack(blocks)

    def run(o, driver):
        if K == 1:
            return _adagrad_run(_wrap_objective(o, flag), n_iters, WINDOW,
                                LR, EPS, LR_END, inits[0], blocks[0],
                                keep_history=True, driver=driver)
        return _adagrad_runs(o, flag, n_iters, WINDOW, lr, EPS, inits, block,
                             keep_history=True, driver=driver)

    _launch.reset_launches()
    fused = run(obj, 'graph')
    counts = _launch.launches['chivi_mf'], _launch.replayed['chivi_mf']
    plain = run(autograd, 'eager')
    assert _launch.launches['chivi_mf'] == counts[0]  # autograd: no launch
    return fused, counts, plain


@pytest.mark.cuda
@pytest.mark.parametrize('log_norm', ['kept', 'off'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('runs', ['single', 'K8'])
@pytest.mark.parametrize('family,model', [('mf_t', 'cp'),
                                          ('mf_gaussian', 'ncp')])
def test_graph_fit_matches_eager_autograd(cuda, family, model, runs, dtype,
                                          log_norm):
    """300 iterations (n_mc 500) through the replayed graph on the kernel
    against the eager autograd run on the same draws, with the log-norm
    kept and with ``has_log_norm=False``: the final parameter, the values,
    the log-norms and the tail mean within 1e-12 relative in float64 and
    1e-5 in float32; the kernel ran once an iteration, every iteration
    after the window's from a replay."""
    K = 1 if runs == 'single' else 8
    n_iters = 300
    flag = None if log_norm == 'kept' else False
    fused, counts, plain = _fit_pair(cuda, family, model, dtype, K, flag,
                                     n_iters)
    assert counts == (n_iters, n_iters - WINDOW)
    values, log_norms, params, tail = fused
    want_values, want_log_norms, want_params, want_tail = plain
    if log_norm == 'off':
        assert not log_norms.any() and not want_log_norms.any()
    for got, want, name in ((params[..., -1, :], want_params[..., -1, :],
                             'param'), (values, want_values, 'values'),
                            (log_norms, want_log_norms, 'log-norms'),
                            (tail, want_tail, 'tail mean')):
        got, want = got.cpu().reshape(K, -1), want.cpu().reshape(K, -1)
        for k in range(K):
            if name == 'log-norms' and log_norm == 'off':
                continue
            assert rel(got[k], want[k]) < TOL[dtype], (name, k)


@pytest.mark.cuda
def test_resumed_run_launches_once_an_iteration(cuda):
    """A run resumed past the window launches the kernel once an
    iteration, all of them from replays, and ends where the run without
    the break ends, bit for bit."""
    n_iters, first = 60, 23
    params, _ = _card_inputs('mf_t', 1, 1, 1, torch.float64, cuda, seed=31)
    obj = _port('mf_t', 'cp', 500)
    wrapped = _wrap_objective(obj, None)
    g = torch.Generator(device=cuda).manual_seed(9)
    block = obj.make_draws(g, n_iters, torch.float64)
    lr = _learning_rates(n_iters, LR, LR_END, torch.float64)
    init = params[0] * 0.1

    def fresh():
        return aops.new_state(init, lr, WINDOW, EPS, False)

    whole = fresh()
    _advance(wrapped, whole, block, 0, n_iters, WINDOW, driver='graph')
    resumed = fresh()
    _advance(wrapped, resumed, block, 0, first, WINDOW, driver='graph')
    _launch.reset_launches()
    _advance(wrapped, resumed, block, first, n_iters - first, WINDOW,
             driver='graph')
    assert _launch.launches['chivi_mf'] == n_iters - first
    assert _launch.replayed['chivi_mf'] == n_iters - first
    assert _launch.launches['klvi_mf'] == 0
    assert torch.equal(resumed.param, whole.param)
    assert torch.equal(resumed.values, whole.values)
    assert torch.equal(resumed.log_norms, whole.log_norms)


@pytest.mark.cuda
def test_validated_vi_and_multistart_engage_the_kernel(cuda):
    """A CHIVI `validated_vi` launches the kernel once an iteration, an
    8-start `validated_vi_multistart` once a batch iteration; every fit
    finite."""
    model = tcp()
    fam = _family('mf_t')
    init = torch.zeros(2 * D, device=cuda)
    n_iters = 200
    obj = pt.black_box_chivi(ALPHA, fam, model, 500, presampled=True)
    _launch.reset_launches()
    out = pt.validated_vi(model, fam, init, n_iters, objective_and_grad=obj,
                          n_bound_samples=20000, device=cuda)
    assert _launch.launches['chivi_mf'] == n_iters
    assert _launch.replayed['chivi_mf'] == n_iters - WINDOW
    assert math.isfinite(out['khat'])
    _launch.reset_launches()
    out = pt.validated_vi_multistart(model, fam, init, n_iters, n_starts=8,
                                     perturb_scale=0.1,
                                     objective_and_grad=obj,
                                     n_bound_samples=20000, device=cuda)
    assert _launch.launches['chivi_mf'] == n_iters
    assert np.all(np.isfinite(np.asarray(out['khat'])))
