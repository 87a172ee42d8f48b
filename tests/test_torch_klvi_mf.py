"""The KLVI value-and-gradient kernel of the mean-field families on the
eight-schools densities (`ops.klvi_mf`): the closed form it computes, the
rule that decides where it runs, and, on the card, the kernel itself.

On the CPU: a float64 NumPy version of the closed-form gradients of the
centred and non-centred eight-schools densities and of the KLVI value and
gradient of both mean-field families, the derivation's record, held
against the port's autograd objective (the kernel's plain version) and
against the JAX package's ``jax.value_and_grad`` of its KLVI objective at
1e-12 relative; the dispatch rule, case by case; the plain version's rows.

On the card (marker ``cuda``; the JAX package is imported inside the
fixture that uses it, so these run where only PyTorch is installed:
``python -m pytest tests/test_torch_klvi_mf.py -m cuda -q --noconftest``):
the kernel against its plain version (float64 1e-12, float32 1e-5
relative), graph-driven fits on the kernel against the eager autograd run
(300 iterations, float64 1e-12, float32 1e-5), the launch counts (a run
resumed past the window's too), and the sweep and a two-group mesh batch
engaging it.
"""
import math

import numpy as np
import pytest
import torch

import viabel_tpu_torch as pt
from viabel_tpu_torch.models import eight_schools_cp_model as tcp
from viabel_tpu_torch.models import eight_schools_ncp_model as tncp
from viabel_tpu_torch.ops import _launch
from viabel_tpu_torch.ops import adagrad as aops
from viabel_tpu_torch.ops import chivi_mf as cops
from viabel_tpu_torch.ops import klvi_mf as kops
from viabel_tpu_torch.ops import mf_kernels
from viabel_tpu_torch.optimizers import (_adagrad_run, _adagrad_runs,
                                         _advance, _batched_objective,
                                         _batched_step,
                                         _iteration_objective,
                                         _learning_rates, _wrap_objective)

Y = np.array([28., 8., -3., 7., -1., 1., 18., 12.])
SIGMA = np.array([15., 10., 16., 11., 9., 11., 10., 18.])
D, N_MC, DF = 10, 100, 40
FAMILIES = ('mf_t', 'mf_gaussian')
MODELS = ('cp', 'ncp')
WINDOW, LR, LR_END, EPS = 10, 0.01, 0.001, 0.1


# --------------------------------------------------------------------------
# the derivation, in float64 NumPy
# --------------------------------------------------------------------------

def np_cp(x):
    """Centred eight schools at the rows of x (n, 10): log p and its
    gradient.  log p = log N(mu; 0, 5) + log half-Cauchy(tau; 5) + log_tau
    + sum_j log N(theta_j; mu, tau) + sum_j log N(y_j; theta_j, sigma_j),
    tau = exp(log_tau).  With zt = (theta - mu) / tau, zy = (y - theta) /
    sigma, u = (tau / 5)^2:
      d/dmu      = -mu / 25 + sum zt / tau
      d/dlog_tau = 1 - 2 u / (1 + u) + sum zt^2 - J     (the -J from the
                   J log tau normalizers, the 1 the Jacobian)
      d/dtheta   = -zt / tau + zy / sigma."""
    mu, lt, th = x[:, 0], x[:, 1], x[:, 2:]
    tau = np.exp(lt)
    u = (tau / 5.0) ** 2
    zt = (th - mu[:, None]) / tau[:, None]
    zy = (Y - th) / SIGMA
    J = len(Y)
    lp = (-0.5 * (mu / 5.0) ** 2 - 0.5 * math.log(2 * math.pi)
          - math.log(5.0) - np.log(math.pi * 5.0 * (1.0 + u)) + lt
          + np.sum(-0.5 * zt ** 2, axis=1) - J * (0.5 * math.log(2 * math.pi)
                                                  + lt)
          + np.sum(-0.5 * zy ** 2 - 0.5 * math.log(2 * math.pi)
                   - np.log(SIGMA), axis=1))
    g = np.empty_like(x)
    g[:, 0] = -mu / 25.0 + np.sum(zt, axis=1) / tau
    g[:, 1] = 1.0 - 2.0 * u / (1.0 + u) + np.sum(zt ** 2, axis=1) - J
    g[:, 2:] = -zt / tau[:, None] + zy / SIGMA
    return lp, g


def np_ncp(x):
    """Non-centred eight schools at the rows of x (n, 10): theta = mu +
    tau tt, tt ~ N(0, 1).  With r = (y - theta) / sigma^2 (the derivative
    of the likelihood in theta) and u = (tau / 5)^2:
      d/dmu      = -mu / 25 + sum r
      d/dlog_tau = 1 - 2 u / (1 + u) + tau sum r tt     (d theta / d log_tau
                   = tau tt)
      d/dtt      = -tt + tau r."""
    mu, lt, tt = x[:, 0], x[:, 1], x[:, 2:]
    tau = np.exp(lt)
    u = (tau / 5.0) ** 2
    theta = mu[:, None] + tau[:, None] * tt
    zy = (Y - theta) / SIGMA
    r = zy / SIGMA
    lp = (-0.5 * (mu / 5.0) ** 2 - 0.5 * math.log(2 * math.pi)
          - math.log(5.0) - np.log(math.pi * 5.0 * (1.0 + u)) + lt
          + np.sum(-0.5 * tt ** 2 - 0.5 * math.log(2 * math.pi), axis=1)
          + np.sum(-0.5 * zy ** 2 - 0.5 * math.log(2 * math.pi)
                   - np.log(SIGMA), axis=1))
    g = np.empty_like(x)
    g[:, 0] = -mu / 25.0 + np.sum(r, axis=1)
    g[:, 1] = 1.0 - 2.0 * u / (1.0 + u) + tau * np.sum(r * tt, axis=1)
    g[:, 2:] = -tt + tau[:, None] * r
    return lp, g


def np_klvi(family, model, param, t):
    """KLVI with the closed-form entropy at `param` = [mean, log_scale] on
    base draws t (n, d): z = mean + exp(log_scale) t, H = sum log_scale
    (the t family, df-only constants dropped) or 0.5 d (1 + log 2 pi) +
    sum log_std (the Gaussian);
      value          = -(H + mean_n log p(z_n))
      grad_mean      = -mean_n g_n
      grad_log_scale = -(1 + exp(log_scale) mean_n g_n t_n)
    (H's derivative in each log-scale is 1)."""
    m, s = param[:D], param[D:]
    lp, g = (np_cp if model == 'cp' else np_ncp)(m + np.exp(s) * t)
    H = np.sum(s) + (0.0 if family == 'mf_t'
                     else 0.5 * D * (1.0 + math.log(2 * math.pi)))
    value = -(H + np.mean(lp))
    grad = np.concatenate([-np.mean(g, axis=0),
                           -(1.0 + np.exp(s) * np.mean(g * t, axis=0))])
    return value, grad


def rel(got, want):
    """||got - want|| / ||want||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(family, K, n_iters=3, seed=0):
    """Parameters near the posterior's scale and base draws of the family,
    (K, 20) and (K, n_iters, n_mc, 10), float64."""
    rng = np.random.default_rng(seed)
    params = np.concatenate([rng.normal(0.0, 2.0, (K, D)),
                             rng.normal(-0.5, 0.4, (K, D))], axis=1)
    params[:, 1] = rng.normal(1.0, 0.5, K)  # log_tau's mean
    shape = (K, n_iters, N_MC, D)
    draws = (rng.standard_t(DF, shape) if family == 'mf_t'
             else rng.standard_normal(shape))
    return params, draws


def _port(family, model, n_mc=N_MC):
    fam = (pt.mean_field_t_variational_family(D, DF) if family == 'mf_t'
           else pt.mean_field_gaussian_variational_family(D))
    target = tcp() if model == 'cp' else tncp()
    return fam, target, pt.black_box_klvi(fam, target, n_mc,
                                          presampled=True)


@pytest.fixture(scope='module')
def jx():
    """The JAX package's families, models and KLVI, on the CPU at x64."""
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    import viabel_tpu as vt
    from viabel_tpu.models import (eight_schools_cp_model,
                                   eight_schools_ncp_model)
    return jax, jnp, vt, eight_schools_cp_model, eight_schools_ncp_model


@pytest.mark.parametrize('model', MODELS)
def test_closed_form_density_gradient_matches_autograd(model):
    """The NumPy log density and gradient against the port's density and
    its autograd gradient, float64."""
    x = np.random.default_rng(1).normal(0.0, 1.5, (64, D))
    target = tcp() if model == 'cp' else tncp()
    xt = torch.tensor(x, requires_grad=True)
    lp = target(xt)
    g, = torch.autograd.grad(lp.sum(), xt)
    np_lp, np_g = (np_cp if model == 'cp' else np_ncp)(x)
    assert rel(np_lp, lp.detach().numpy()) < 1e-13
    assert rel(np_g, g.numpy()) < 1e-12


@pytest.mark.parametrize('runs', ['single', 'K8'])
@pytest.mark.parametrize('model', MODELS)
@pytest.mark.parametrize('family', FAMILIES)
def test_closed_form_klvi_matches_autograd_and_jax(jx, family, model, runs):
    """The NumPy KLVI value and gradient against the port's autograd
    objective (`ops.klvi_mf.klvi_mf_plain` on the counter's row, vmapped
    over a batch) and the JAX package's ``jax.value_and_grad`` of its
    objective on the same draws, 1e-12 relative."""
    jax, jnp, vt, jcp, jncp = jx
    K = 1 if runs == 'single' else 8
    params, draws = _inputs(family, K, seed=2 + K)
    counter = np.arange(K) % draws.shape[1]
    _, _, obj = _port(family, model)
    jfam = (vt.mean_field_t_variational_family(D, DF) if family == 'mf_t'
            else vt.mean_field_gaussian_variational_family(D))
    jmodel = jcp() if model == 'cp' else jncp()
    jobj = vt.black_box_klvi(jfam, jmodel.log_prob, N_MC, presampled=True)
    if runs == 'single':
        tv, tg = kops.klvi_mf_plain(obj.objective, torch.tensor(params[0]),
                                    torch.tensor(draws[0]),
                                    torch.tensor(counter[:1]))
        tv, tg = tv[None], tg[None]
    else:
        tv, tg = kops.klvi_mf_plain(obj.objective, torch.tensor(params),
                                    torch.tensor(draws),
                                    torch.tensor(counter))
    for k in range(K):
        row = draws[k, counter[k]]
        nv, ng = np_klvi(family, model, params[k], row)
        jv, jg = jobj(jnp.asarray(params[k]), jnp.asarray(row))
        assert abs(float(tv[k]) - nv) <= 1e-12 * abs(nv)
        assert abs(float(jv) - nv) <= 1e-12 * abs(nv)
        assert rel(tg[k].numpy(), ng) < 1e-12
        assert rel(np.asarray(jg), ng) < 1e-12


# --------------------------------------------------------------------------
# the dispatch rule
# --------------------------------------------------------------------------

def _case(name):
    """An objective of each kind the rule must tell apart, and whether the
    kernel's body goes with it (it engages only on a CUDA parameter)."""
    from viabel_tpu_torch.models import (funnel_model,
                                         make_callback_log_density,
                                         robust_regression_model)
    mft = pt.mean_field_t_variational_family(D, DF)
    mfg = pt.mean_field_gaussian_variational_family(D)
    cp, ncp = tcp(), tncp()
    cases = {
        'mf_t_cp': (lambda: pt.black_box_klvi(mft, cp, 20, True), True),
        'mf_t_ncp': (lambda: pt.black_box_klvi(mft, ncp, 20, True), True),
        'mf_gaussian_cp': (lambda: pt.black_box_klvi(mfg, cp, 20, True),
                           True),
        'mf_gaussian_ncp': (lambda: pt.black_box_klvi(mfg, ncp, 20, True),
                            True),
        'not_presampled': (lambda: pt.black_box_klvi(mft, cp, 20), False),
        'full_rank_gaussian': (lambda: pt.black_box_klvi(
            pt.full_rank_gaussian_variational_family(D), cp, 20, True),
            False),
        'full_rank_t': (lambda: pt.black_box_klvi(
            pt.t_variational_family(D, DF), cp, 20, True), False),
        'funnel': (lambda: pt.black_box_klvi(
            pt.mean_field_t_variational_family(2, DF), funnel_model(), 20,
            True), False),
        'robust_regression': (lambda: pt.black_box_klvi(
            pt.mean_field_t_variational_family(2, DF),
            robust_regression_model(), 20, True), False),
        'schools_of_seven': (lambda: pt.black_box_klvi(
            pt.mean_field_t_variational_family(9, DF),
            tcp(Y[:7], SIGMA[:7]), 20, True), False),
        'log_prob_not_model': (lambda: pt.black_box_klvi(
            mft, cp.log_prob, 20, True), False),
        'host_callback': (lambda: pt.black_box_klvi(
            mft, make_callback_log_density(
                lambda x: np.zeros(len(x)), lambda x: np.zeros_like(x), D,
                batched=True), 20, True), False),
        'klvi_pd': (lambda: pt.black_box_klvi_pd(mft, cp, 20, True), False),
        'klvi_pd2': (lambda: pt.black_box_klvi_pd2(mft, cp, 20, True),
                     False),
        'chivi': (lambda: pt.black_box_chivi(2, mft, cp, 20, True), True),
        'perturbed': (lambda: pt.perturbed_black_box_vi(mft, cp, 20), False),
    }
    make, carries = cases[name]
    return make(), carries


DISPATCH_CASES = ('mf_t_cp', 'mf_t_ncp', 'mf_gaussian_cp',
                  'mf_gaussian_ncp', 'not_presampled', 'full_rank_gaussian',
                  'full_rank_t', 'funnel', 'robust_regression',
                  'schools_of_seven', 'log_prob_not_model', 'host_callback',
                  'klvi_pd', 'klvi_pd2', 'chivi', 'perturbed')


@pytest.mark.parametrize('case', DISPATCH_CASES)
def test_dispatch_rule(case):
    """The objective carries the kernel's body exactly for presampled KLVI
    of a mean-field family on an eight-schools `Model` (presampled CHIVI
    there carries `ops.chivi_mf`'s); the wrapped and the batched adagrad
    objectives carry it on, the IA chains' step never; and on the CPU no
    body engages, so a CPU run keeps its autograd body."""
    obj, carries = _case(case)
    body = getattr(obj, 'fused', None)
    assert (body is not None) == carries
    assert getattr(_wrap_objective(obj, None), 'fused', None) is body
    if getattr(obj, 'presampled', False):
        try:
            batched = _batched_objective(obj, None)
        except NotImplementedError:  # the pd forms' log-norm-free vmap
            batched = None
        if batched is not None:
            assert batched.fused is body
        assert getattr(_batched_step(obj, None), 'fused', None) is None
    if body is None:
        return
    assert type(body) is mf_kernels.MeanFieldBody
    assert body.name == ('chivi_mf' if case == 'chivi' else 'klvi_mf')
    # the family rides in the first own argument: CHIVI's t flag, KLVI's
    # entropy constant (0 for the t family)
    assert (body.own[0] == (1 if case == 'chivi' else 0)) == (
        not case.startswith('mf_gaussian'))
    assert body.model.kernel in mf_kernels.MODELS
    param = torch.zeros(2 * D, dtype=torch.float64)
    draws = torch.zeros(4, 20, D, dtype=torch.float64)
    assert not body.engages(param, draws)      # the CPU
    state = aops.new_state(param, _learning_rates(4, LR, None,
                                                  torch.float64),
                           WINDOW, EPS, False)
    _, fused = _iteration_objective(_wrap_objective(obj, None), state, draws)
    assert fused is None


@pytest.mark.parametrize('layout,fits', [
    ('single', True), ('batch', True), ('batch_sliced_iterations', True),
    ('rows_not_contiguous', False), ('dtype_differs', False),
    ('float16', False), ('runs_differ', False), ('dim_differs', False),
    ('dict_draws', False), ('generator', False)])
def test_layouts_the_kernel_takes(layout, fits):
    """The layouts of parameter and draws the kernel reads (its rule past
    the device: a CUDA float32 or float64 parameter): a run's rows
    contiguous, runs any stride apart (a batch's block sliced to fewer
    iterations too), the draws in the parameter's dtype beside it."""
    f64 = torch.float64
    param, draws = torch.zeros(2 * D, dtype=f64), torch.zeros(5, 7, D,
                                                              dtype=f64)
    batch, block = torch.zeros(3, 2 * D, dtype=f64), torch.zeros(
        3, 5, 7, D, dtype=f64)
    cases = {
        'single': (param, draws),
        'batch': (batch, block),
        'batch_sliced_iterations': (batch, block[:, :2]),
        'rows_not_contiguous': (param, draws.transpose(0, 1)),
        'dtype_differs': (param, draws.float()),
        'float16': (param.half(), draws.half()),
        'runs_differ': (batch, block[:2]),
        'dim_differs': (torch.zeros(8, dtype=f64),
                        torch.zeros(5, 7, 4, dtype=f64)),
        'dict_draws': (param, {'z': draws}),
        'generator': (param, torch.Generator()),
    }
    p, d = cases[layout]
    try:
        mf_kernels.layout(p, d)
        took = True
    except (TypeError, ValueError):
        took = False
    assert took == fits


@pytest.mark.parametrize('runs', ['single', 'K3'])
def test_plain_version_reads_the_counters_row(runs):
    """The plain version, which runs off the card keep, is the autograd
    objective on row ``counter[k]`` of run k's block (row 0 without a
    counter)."""
    _, _, obj = _port('mf_t', 'cp', n_mc=7)
    K = 1 if runs == 'single' else 3
    rng = np.random.default_rng(5)
    params = torch.tensor(rng.normal(0, 0.5, (K, 2 * D)))
    block = torch.tensor(rng.standard_t(DF, (K, 4, 7, D)))
    if runs == 'single':
        params, block = params[0], block[0]
    counter = torch.full((K,), 2, dtype=torch.int64)
    for c in (counter, None):
        value, grad = kops.klvi_mf_plain(obj.objective, params, block, c)
        row = 2 if c is not None else 0
        for k in range(K):
            p = params[k] if runs == 'K3' else params
            rows = block[k] if runs == 'K3' else block
            v, g = obj(p, rows[row])
            got_v = value[k] if runs == 'K3' else value
            got_g = grad[k] if runs == 'K3' else grad
            assert abs(float(got_v - v)) <= 1e-14 * abs(float(v))
            assert rel(got_g, g) < 1e-14


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('runs', ['single', 'K8'])
@pytest.mark.parametrize('model', MODELS)
@pytest.mark.parametrize('family', FAMILIES)
def test_kernel_matches_plain(cuda, family, model, runs, dtype):
    """The kernel's value and gradient against its plain version (the
    autograd objective) on the counters' rows, 1e-12 relative in float64
    and 1e-5 in float32; one launch counted; a counter past the block
    gives NaN."""
    K = 1 if runs == 'single' else 8
    params, draws = _inputs(family, K, n_iters=5, seed=11 + K)
    p = torch.tensor(params, dtype=dtype, device=cuda)
    block = torch.tensor(draws, dtype=dtype, device=cuda)
    counter = torch.tensor(np.arange(K) % 5, device=cuda)
    if runs == 'single':
        p, block, counter = p[0], block[0], counter[:1].clone()
    _, _, obj = _port(family, model)
    evaluate = obj.fused.bind(p, block, counter)
    before = _launch.launches['klvi_mf']
    value, grad, log_norm = evaluate()
    assert log_norm is None
    assert _launch.launches['klvi_mf'] == before + 1
    want_v, want_g = kops.klvi_mf_plain(obj.objective, p, block, counter)
    vals = value.reshape(-1).cpu().double().numpy()
    wv = want_v.reshape(-1).cpu().double().numpy()
    assert np.all(np.abs(vals - wv) <= TOL[dtype] * np.abs(wv))
    g, wg = grad.reshape(K, -1).cpu(), want_g.reshape(K, -1).cpu()
    for k in range(K):
        assert rel(g[k], wg[k]) < TOL[dtype], k
    counter.fill_(5)
    value, grad, _ = evaluate()
    assert torch.isnan(value).all() and torch.isnan(grad).all()


def _fit_pair(cuda, family, model, dtype, K, n_iters=300):
    """The graph-driven fit on the kernel and the eager autograd run of
    the same objective on the same draws: ``(outs, (launches, replayed),
    autograd outs)``."""
    params, _ = _inputs(family, K, seed=21)
    inits = torch.tensor(params * 0.1, dtype=dtype, device=cuda)
    _, _, obj = _port(family, model)
    _, _, autograd = _port(family, model)
    autograd.fused = None
    g = torch.Generator(device=cuda).manual_seed(7)
    blocks = [obj.make_draws(g, n_iters, dtype) for _ in range(K)]
    lr = _learning_rates(n_iters, LR, LR_END, dtype).repeat(K, 1)
    block = torch.stack(blocks)

    def run(o, driver):
        if K == 1:
            return _adagrad_run(_wrap_objective(o, None), n_iters, WINDOW,
                                LR, EPS, LR_END, inits[0], blocks[0],
                                keep_history=True, driver=driver)
        return _adagrad_runs(o, None, n_iters, WINDOW, lr, EPS, inits, block,
                             keep_history=True, driver=driver)

    _launch.reset_launches()
    fused = run(obj, 'graph')
    counts = _launch.launches['klvi_mf'], _launch.replayed['klvi_mf']
    plain = run(autograd, 'eager')
    assert _launch.launches['klvi_mf'] == counts[0]  # autograd: no launch
    return fused, counts, plain


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('runs', ['single', 'K8'])
@pytest.mark.parametrize('family,model', [('mf_t', 'cp'),
                                          ('mf_gaussian', 'ncp')])
def test_graph_fit_matches_eager_autograd(cuda, family, model, runs, dtype):
    """300 iterations through the replayed graph on the kernel against the
    eager autograd run on the same draws: the final parameter, the values
    and the tail mean within 1e-12 relative in float64 and 1e-5 in
    float32; the kernel ran once an iteration, every iteration after the
    window's from a replay."""
    K = 1 if runs == 'single' else 8
    n_iters = 300
    fused, counts, plain = _fit_pair(cuda, family, model, dtype, K, n_iters)
    assert counts == (n_iters, n_iters - WINDOW)
    values, _, params, tail = fused
    want_values, _, want_params, want_tail = plain
    for got, want, name in ((params[..., -1, :], want_params[..., -1, :],
                             'param'), (values, want_values, 'values'),
                            (tail, want_tail, 'tail mean')):
        got, want = got.cpu().reshape(K, -1), want.cpu().reshape(K, -1)
        for k in range(K):
            assert rel(got[k], want[k]) < TOL[dtype], (name, k)


@pytest.mark.cuda
def test_resumed_run_launches_once_an_iteration(cuda):
    """A run resumed past the window (a checkpoint's) launches the kernel
    once an iteration, all of them from replays, and ends where the run
    without the break ends, bit for bit: the autograd body's discarded
    warm-up evaluation has no counterpart on this path."""
    n_iters, first = 60, 23
    params, _ = _inputs('mf_t', 1, seed=31)
    _, _, obj = _port('mf_t', 'cp')
    wrapped = _wrap_objective(obj, None)
    g = torch.Generator(device=cuda).manual_seed(9)
    block = obj.make_draws(g, n_iters, torch.float64)
    lr = _learning_rates(n_iters, LR, LR_END, torch.float64)
    init = torch.tensor(params[0] * 0.1, device=cuda)

    def fresh():
        return aops.new_state(init, lr, WINDOW, EPS, False)

    whole = fresh()
    _advance(wrapped, whole, block, 0, n_iters, WINDOW, driver='graph')
    resumed = fresh()
    _advance(wrapped, resumed, block, 0, first, WINDOW, driver='graph')
    _launch.reset_launches()
    _advance(wrapped, resumed, block, first, n_iters - first, WINDOW,
             driver='graph')
    assert _launch.launches['klvi_mf'] == n_iters - first
    assert _launch.replayed['klvi_mf'] == n_iters - first
    assert torch.equal(resumed.param, whole.param)
    assert torch.equal(resumed.values, whole.values)


@pytest.mark.cuda
def test_sweep_and_mesh_batch_engage_the_kernel(cuda):
    """`validated_vi_sweep`'s batch launches the kernel once an
    iteration for all its rates, a multistart on a two-group chain mesh
    on one card once an iteration a group, and `validated_vi` once an
    iteration; every fit finite."""
    from viabel_tpu_torch.parallel import make_mesh

    model = tcp()
    fam = pt.mean_field_t_variational_family(D, DF)
    init = torch.zeros(2 * D, device=cuda)
    n_iters = 200
    _launch.reset_launches()
    out = pt.validated_vi_sweep(model, fam, init, n_iters,
                                learning_rates=[0.005, 0.01, 0.02],
                                n_bound_samples=20000, device=cuda)
    assert _launch.launches['klvi_mf'] == n_iters
    assert _launch.replayed['klvi_mf'] == n_iters - WINDOW
    assert np.all(np.isfinite(np.asarray(out['khat'])))
    _launch.reset_launches()
    mesh = make_mesh(('chain',), devices=['cuda:0'] * 2)
    out = pt.validated_vi_multistart(model, fam, init, n_iters, n_starts=4,
                                     perturb_scale=0.1,
                                     n_bound_samples=20000, mesh=mesh)
    assert _launch.launches['klvi_mf'] == 2 * n_iters
    assert np.all(np.isfinite(np.asarray(out['khat'])))
    _launch.reset_launches()
    out = pt.validated_vi(model, fam, init, n_iters, n_bound_samples=20000,
                          device=cuda)
    assert _launch.launches['klvi_mf'] == n_iters
    assert math.isfinite(out['khat'])
