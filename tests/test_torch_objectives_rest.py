"""The port's path-derivative KLVI forms, `black_box_chivi_neff`,
`perturbed_black_box_vi` and `vectorize_log_density` against
viabel_tpu.objectives at float64, on shared draws.

Values agree to 1e-12 relative and gradients to 1e-10 (the tolerance of
the port's other objective tests: the backward passes sum the same terms
in another order).  The t family's draws are the pair ``{'z', 'chi2'}``,
which presampling, the counter's row select and `interop` carry as a dict.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import robust_regression_model as jrr
from viabel_tpu_torch import interop
from viabel_tpu_torch.models import robust_regression_model as trr
from viabel_tpu_torch.optimizers import _batched_step, _draw_row

FAMILIES = {
    'mf_t': lambda m: m.mean_field_t_variational_family(2, 40),
    'full_rank_gaussian': lambda m: m.full_rank_gaussian_variational_family(2),
    'full_rank_t': lambda m: m.t_variational_family(2, 100),
}


def _draws(jobj, n_iters=3, key=2):
    jd = jobj.make_draws(jax.random.PRNGKey(key), n_iters, jnp.float64)
    return jd, interop.presampled_draws(jax.tree.map(np.asarray, jd))


def _row(draws, i):
    return jax.tree.map(lambda v: v[i], draws)


def _param(fam, seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, fam.var_param_dim)


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('form', ['klvi_pd', 'klvi_pd2'])
def test_path_derivative_klvi_on_shared_draws(form, family):
    jf, tf = FAMILIES[family](vt), FAMILIES[family](pt)
    make_j = getattr(vt, 'black_box_' + form)
    make_t = getattr(pt, 'black_box_' + form)
    jobj = make_j(jf, jrr().log_prob, 40, presampled=True)
    tobj = make_t(tf, trr(), 40, presampled=True)
    assert tobj.presampled and not tobj.has_log_norm
    assert callable(tobj.objective)
    vp = _param(tf)
    jd, td = _draws(jobj)
    for i in range(3):
        jv, jg = jobj(jnp.asarray(vp), _row(jd, i))
        tv, tg = tobj(interop.var_param(vp), _row(td, i))
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                                   atol=1e-12)


def test_pd2_drops_the_score_path():
    """At q = p the sticking-the-landing gradient is zero on every draw:
    log p - log q is constant in x, and its parameters are held fixed."""
    fam = pt.mean_field_gaussian_variational_family(2)
    vp = torch.tensor([0.3, -0.2, 0.1, -0.4], dtype=torch.float64)
    mean, log_std = vp[:2], vp[2:]

    def log_p(x):
        return pt.distributions.diag_normal_logpdf(x, mean, log_std)

    obj = pt.black_box_klvi_pd2(fam, log_p, 30, presampled=True)
    pd = pt.black_box_klvi_pd(fam, log_p, 30, presampled=True)
    z = fam.base_sample(torch.Generator().manual_seed(0), 30, torch.float64)
    _, grad = obj(vp, z)
    torch.testing.assert_close(grad, torch.zeros(4, dtype=torch.float64),
                               rtol=0, atol=1e-12)
    assert pd(vp, z)[1].abs().max() > 1e-3  # the pd form keeps it


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_chivi_neff_on_shared_draws(family):
    jf, tf = FAMILIES[family](vt), FAMILIES[family](pt)
    jobj = vt.black_box_chivi_neff(2, jf, jrr().log_prob, 60,
                                   presampled=True)
    tobj = pt.black_box_chivi_neff(2, tf, trr(), 60, presampled=True)
    assert tobj.has_log_norm and tobj.presampled
    vp = _param(tf, 1)
    jd, td = _draws(jobj)
    for i in range(3):
        want = jobj(jnp.asarray(vp), _row(jd, i))
        got = tobj(interop.var_param(vp), _row(td, i))
        assert len(got) == 4
        for g, w, name in zip(got, want, ('value', 'grad', 'log_norm',
                                          'n_eff')):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-10, atol=1e-12, err_msg=name)
        n_eff = float(got[3])
        assert 1.0 <= n_eff <= 60.0
    # the n_eff-scaled gradient is CHIVI's times n_eff / n
    chivi = pt.black_box_chivi(2, tf, trr(), 60, presampled=True)
    row = _row(td, 0)
    value, grad, log_norm = chivi(interop.var_param(vp), row)
    got = tobj(interop.var_param(vp), row)
    torch.testing.assert_close(got[1], grad * got[3] / 60, rtol=1e-12,
                               atol=0)
    assert float(got[0]) == float(value) and float(got[2]) == float(log_norm)


@pytest.mark.parametrize('family', ['mf_t', 'full_rank_t'])
def test_perturbed_vi_on_shared_noise_and_draws(family):
    """The JAX package's objective splits its key into the perturbation
    noise's key and the sample key; the port's pure function takes that
    noise (standard normal) and the sample key's base draws."""
    jf, tf = FAMILIES[family](vt), FAMILIES[family](pt)
    jobj = vt.perturbed_black_box_vi(jf, jrr().log_prob, 50,
                                     perturbation_scale=0.2)
    tobj = pt.perturbed_black_box_vi(tf, trr(), 50, perturbation_scale=0.2)
    assert not tobj.has_log_norm and not getattr(tobj, 'presampled', False)
    vp = _param(tf, 2)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jv, jg = jobj(jnp.asarray(vp), key)
        perturb_key, sample_key = jax.random.split(key)
        noise = jax.random.normal(perturb_key, vp.shape, dtype=jnp.float64)
        draws = jax.tree.map(np.asarray,
                             jf.base_sample(sample_key, 50, jnp.float64))
        tg, tv = torch.func.grad_and_value(tobj.perturbed_objective)(
            interop.var_param(vp), interop.var_param(noise),
            interop.base_draws(draws))
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                                   atol=1e-12)


def test_perturbed_vi_draws_noise_then_samples():
    fam = pt.mean_field_t_variational_family(2, 40)
    obj = pt.perturbed_black_box_vi(fam, trr(), 20, perturbation_scale=0.3)
    vp = torch.tensor([0.1, -0.2, 0.0, 0.3], dtype=torch.float64)
    value, grad = obj(vp, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    noise = torch.randn(4, generator=g, dtype=torch.float64)
    draws = fam.base_sample(g, 20, torch.float64)
    want = obj.perturbed_objective(vp, noise, draws)
    assert float(value) == float(want)
    assert grad.shape == (4,) and torch.isfinite(grad).all()


def test_vectorize_log_density_matches_jax():
    def j_point(x):
        return -0.5 * jnp.sum(x ** 2) + jnp.sin(x[0]) * x[1]

    def t_point(x):
        return -0.5 * torch.sum(x ** 2) + torch.sin(x[0]) * x[1]

    x = np.random.default_rng(3).normal(size=(7, 3))
    jf, tf = vt.vectorize_log_density(j_point), \
        pt.vectorize_log_density(t_point)
    np.testing.assert_allclose(tf(torch.as_tensor(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), rtol=1e-14)
    assert tf(torch.as_tensor(x[0])).shape == ()
    # and it feeds an objective like any batched density
    fam = pt.mean_field_gaussian_variational_family(3)
    obj = pt.black_box_klvi(fam, tf, 10, presampled=True)
    z = fam.base_sample(torch.Generator().manual_seed(0), 10, torch.float64)
    value, grad = obj(torch.zeros(6, dtype=torch.float64), z)
    assert torch.isfinite(grad).all()


def test_dict_draws_through_presampling_and_the_row_select():
    fam = pt.t_variational_family(2, 100)
    obj = pt.black_box_klvi(fam, trr(), 7, presampled=True)
    block = obj.make_draws(torch.Generator().manual_seed(0), 5,
                           torch.float64)
    assert block['z'].shape == (5, 7, 2) and block['chi2'].shape == (5, 7)
    flat = fam.base_sample(torch.Generator().manual_seed(0), 35,
                           torch.float64)
    assert torch.equal(block['z'].reshape(35, 2), flat['z'])
    assert torch.equal(block['chi2'].reshape(35), flat['chi2'])
    row = _draw_row(block, torch.tensor([3]), batched=False)
    assert torch.equal(row['z'], block['z'][3])
    assert torch.equal(row['chi2'], block['chi2'][3])
    runs = {k: torch.stack([v, v + 1]) for k, v in block.items()}
    row = _draw_row(runs, torch.tensor([2, 2]), batched=True)
    assert torch.equal(row['chi2'], torch.stack([block['chi2'][2],
                                                 block['chi2'][2] + 1]))
    with pytest.raises(TypeError, match='presampled'):
        obj(torch.zeros(5, dtype=torch.float64),
            {'z': block['z'][0], 'chi2': torch.ones(7, dtype=torch.int64)})
    with pytest.raises(ValueError, match="'chi2'"):
        interop.presampled_draws({'z': np.zeros((2, 3, 2)),
                                  'chi2': np.zeros((2, 3, 1))})


@pytest.mark.parametrize('form', ['klvi', 'chivi', 'chivi_neff'])
@pytest.mark.parametrize('family', ['mf_t', 'full_rank_t'])
def test_batched_step_is_the_objective_of_each_run(family, form):
    """`_batched_step`'s vmapped value, gradient and log-norm of K runs at
    once equal the objective's own at each run (CHIVI's through a vmapped
    `torch.func.vjp` with the stopped cotangent), 1e-12 relative."""
    fam = FAMILIES[family](pt)
    if form == 'klvi':
        obj = pt.black_box_klvi(fam, trr(), 30, presampled=True)
    else:
        obj = getattr(pt, 'black_box_' + form)(2, fam, trr(), 30,
                                               presampled=True)
    K = 3
    params = torch.as_tensor(np.stack([_param(fam, s) for s in range(K)]))
    block = obj.make_draws(torch.Generator().manual_seed(1), K,
                           torch.float64)  # one row a run
    values, grads, log_norms = _batched_step(obj, None)(params, block)
    for k in range(K):
        out = obj(params[k], {key: v[k] for key, v in block.items()}
                  if isinstance(block, dict) else block[k])
        torch.testing.assert_close(values[k], out[0], rtol=1e-12, atol=0)
        torch.testing.assert_close(grads[k], out[1], rtol=1e-12,
                                   atol=1e-14)
        want_ln = out[2] if form != 'klvi' else torch.zeros(())
        torch.testing.assert_close(log_norms[k], want_ln.to(values.dtype),
                                   rtol=1e-12, atol=0)
    if form != 'klvi':  # has_log_norm=False keeps the gradient, zeroes the
        _, grads0, ln0 = _batched_step(obj, False)(params, block)  # norm
        assert torch.equal(grads0, grads) and not ln0.any()
