"""Parity of the port's HMC (viabel_tpu_torch/mcmc.py) with the JAX
package's (viabel_tpu/mcmc.py) on the CPU, float64.

The port draws each phase's randomness in one block and runs every chain
through `max_steps` masked leapfrog steps; the JAX package folds a key per
transition and runs each chain's own count under ``vmap``.  Fed the draws
the JAX package derives from its keys (reproduced here with JAX), the
port's leapfrog, transition and phases must give the JAX package's
positions, step sizes and accept probabilities.  A flipped accept (a uniform within rounding of its accept
probability) would fail these tests by far more than the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu.mcmc as jmcmc
import viabel_tpu_torch as pt
from viabel_tpu.models import eight_schools_ncp_model as j_ncp_model
from viabel_tpu.models import linear_regression_model as j_linear_model
from viabel_tpu_torch import mcmc
from viabel_tpu_torch.models import (Model, eight_schools_ncp_model,
                                     linear_regression_model,
                                     robust_regression_model)
from viabel_tpu_torch.native import (build_native_library,
                                     native_robust_regression_log_density)


def _conjugate_data(seed=0):
    """tests/test_mcmc.py:18-23's conjugate regression data."""
    rs = np.random.RandomState(seed)
    x = rs.randn(60, 2)
    y = x @ np.array([1.0, -1.0]) + 0.5 * rs.randn(60)
    return x, y


def _models(name):
    """(JAX model, port model) of one target."""
    if name == 'eight_schools_ncp':
        return j_ncp_model(), eight_schools_ncp_model()
    x, y = _conjugate_data()
    return j_linear_model(x, y), linear_regression_model(x, y)


def _jax_phase_draws(key, n_chains, n_iters, d, max_steps):
    """The draws of one phase of viabel_tpu.mcmc._hmc_phase: chain c's
    transition i splits ``fold_in(split(key, C)[c], i)`` in three for the
    momentum normals, the length and the accept uniform
    (viabel_tpu/mcmc.py:71-73, 112), as ``mcmc._Draws`` with rows
    (n_iters, chains)."""
    def one(chain_key, i):
        k_mom, k_len, k_acc = jax.random.split(
            jax.random.fold_in(chain_key, i), 3)
        return (jax.random.normal(k_mom, (d,), dtype=jnp.float64),
                jax.random.randint(k_len, (), 1, max_steps + 1),
                jax.random.uniform(k_acc, (), dtype=jnp.float64))

    grid = jax.vmap(jax.vmap(one, in_axes=(None, 0)), in_axes=(0, None))
    normals, lengths, uniforms = grid(jax.random.split(key, n_chains),
                                      jnp.arange(n_iters))
    return mcmc._Draws(
        torch.tensor(np.asarray(normals).transpose(1, 0, 2)),
        torch.tensor(np.asarray(lengths).T.astype(np.int64)),
        torch.tensor(np.asarray(uniforms).T))


def _points(n, d, seed):
    rs = np.random.RandomState(seed)
    return 0.3 * rs.randn(n, d)


@pytest.mark.parametrize('name', ['eight_schools_ncp', 'linear_regression'])
def test_masked_leapfrog_matches_jax(name):
    """Every chain runs `max_steps` steps, moving only for its first
    n_steps: the JAX package's `_leapfrog` under ``jax.vmap`` with a
    per-chain count (rtol 1e-12)."""
    jm, tm = _models(name)
    C, d, max_steps = 5, jm.dim, 9
    q, p = _points(C, d, 1), _points(C, d, 2) / 0.3
    eps = np.array([0.05, 0.1, 0.02, 0.08, 0.11])
    inv_mass = 0.5 + np.arange(d) / d
    n_steps = np.array([1, 9, 4, 7, 3])
    grad_fn = jax.grad(lambda x: jnp.reshape(jm.log_prob(x), ()))
    jq, jp = jax.vmap(
        lambda q, p, e, n: jmcmc._leapfrog(grad_fn, q, p, e, inv_mass, n))(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(eps),
            jnp.asarray(n_steps))
    tq = torch.tensor(q)
    lp, grad = mcmc._value_and_grad(tm.log_prob, tq)
    got = mcmc._leapfrog(tm.log_prob, tq, torch.tensor(p), grad, lp,
                         torch.tensor(eps), torch.tensor(inv_mass),
                         torch.tensor(n_steps), max_steps)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jq), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jp), rtol=1e-12,
                               atol=1e-12)
    # the carried log density and gradient are those at the end point
    lp_end, grad_end = mcmc._value_and_grad(tm.log_prob, got[0])
    np.testing.assert_allclose(got[3].numpy(), lp_end.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got[2].numpy(), grad_end.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize('name', ['eight_schools_ncp', 'linear_regression'])
def test_transition_on_jax_draws(name):
    """One transition of every chain fed the draws `_hmc_transition`
    derives from each chain's key: q out and the accept probability
    (rtol 1e-12)."""
    jm, tm = _models(name)
    C, d, max_steps = 6, jm.dim, 12
    q = _points(C, d, 3)
    eps = np.array([0.02, 0.05, 0.1, 0.2, 0.4, 0.8])
    inv_mass = 1.0 + np.arange(d) / d
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    lp1 = lambda x: jnp.reshape(jm.log_prob(x), ())  # noqa: E731
    jq, jprob, _ = jax.vmap(
        lambda q, k, e: jmcmc._hmc_transition(
            lp1, jax.grad(lp1), q, k, e, inv_mass, max_steps))(
                jnp.asarray(q), keys, jnp.asarray(eps))

    def derived(key):
        k_mom, k_len, k_acc = jax.random.split(key, 3)
        return (jax.random.normal(k_mom, (d,), dtype=jnp.float64),
                jax.random.randint(k_len, (), 1, max_steps + 1),
                jax.random.uniform(k_acc, (), dtype=jnp.float64))

    normal, n_steps, uniform = (np.asarray(a) for a in
                                jax.vmap(derived)(keys))
    tq = torch.tensor(q)
    lp, grad = mcmc._value_and_grad(tm.log_prob, tq)
    got_q, got_lp, _, got_prob = mcmc._transition(
        tm.log_prob, tq, lp, grad, torch.tensor(eps),
        torch.tensor(inv_mass), torch.tensor(normal),
        torch.tensor(n_steps.astype(np.int64)), torch.tensor(uniform),
        max_steps)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(jq), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got_prob.numpy(), np.asarray(jprob),
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(got_lp.numpy(),
                               tm.log_prob(got_q).numpy(), rtol=1e-12)


# The adaptive phases amplify any rounding difference: dual averaging
# moves log eps by sqrt(t) / gamma * w ~ 3 per unit of accept probability,
# and the accept probability moves with eps.  The JAX package against
# itself, its start moved by one part in 5e15, differs by 2.4e-10 after 22
# adaptive transitions on the regression and 1.2e-8 after 24; on
# eight-schools NCP (whose funnel gives steep gradients) by 1.5e-9 after 8
# and 1.7e-6 after 15; its sampling phase at a fixed step size stays
# within 2e-15 over 100 on both.  No two implementations whose arithmetic
# differs by an ulp can agree to 1e-8 over a whole run's 40 or more
# adaptive transitions, so each phase is held here on the JAX package's
# inputs: the adaptive phase on the regression over 16 transitions, where
# the JAX package's own one-ulp spread stays below 1e-12, and the sampling
# phase over 100 on both targets; single transitions of both are held at
# 1e-12 above.
@pytest.mark.parametrize('name, adapt, n_iters, mass', [
    ('linear_regression', True, 16, 'unit'),
    ('linear_regression', True, 16, 'estimated'),
    ('linear_regression', False, 100, 'estimated'),
    ('eight_schools_ncp', False, 100, 'estimated'),
    ('eight_schools_ncp', False, 100, 'unit')])
def test_phase_matches_jax_hmc_phase(name, adapt, n_iters, mass):
    """One phase (`_phase`: the device-side state, the counter, the draws
    read by row) against `viabel_tpu.mcmc._hmc_phase` on the draws it
    derives from its chain keys: positions, step sizes and mean accept
    probabilities at rtol 1e-8."""
    jm, tm = _models(name)
    C, d, max_steps = 3, jm.dim, 32
    key = jax.random.PRNGKey(5)
    q0 = _points(C, d, 7)
    eps0 = np.array([0.1, 0.05, 0.2])
    inv_mass = (np.ones(d) if mass == 'unit'
                else 0.2 + np.arange(d) / d)
    lp1 = jmcmc._scalar_log_prob(jm.log_prob)
    j_qs, j_q, j_eps, j_acc = jmcmc._hmc_phase(
        lp1, n_iters, max_steps, adapt, 0.8, jnp.asarray(q0),
        jax.random.split(key, C), jnp.asarray(eps0), jnp.asarray(inv_mass))
    draws = _jax_phase_draws(key, C, n_iters, d, max_steps)
    qs, q, eps, acc = mcmc._phase(tm.log_prob, torch.tensor(q0), draws,
                                  torch.tensor(eps0),
                                  torch.tensor(inv_mass), adapt, 0.8,
                                  max_steps)
    np.testing.assert_allclose(qs.numpy(), np.asarray(j_qs), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(q.numpy(), np.asarray(j_q), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps), rtol=1e-8)
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=1e-8)


def test_hmc_core_phases_and_mass():
    """`_hmc_core` composes the phases as the JAX package does
    (viabel_tpu/mcmc.py:203-236): warmup I from unit mass, the inverse
    mass the pooled population variance of the second half of warmup I's
    draws (at least 1e-8), warmup II and sampling under it at the adapted
    step sizes.  Each call of `_phase` is checked against a rerun of the
    same phase on the inputs it was given."""
    x, y = _conjugate_data()
    model = linear_regression_model(x, y)
    g = torch.Generator().manual_seed(2)
    C, d = 3, model.dim
    q0 = torch.randn((C, d), generator=g, dtype=torch.float64)
    phases = [mcmc._phase_draws(g, n, C, d, 32, torch.float64)
              for n in (20, 21, 30)]
    calls = []
    real = mcmc._phase

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    mcmc._phase = spy
    try:
        samples, eps, inv_mass, accept = mcmc._hmc_core(
            model.log_prob, q0, phases, 0.1, 32, 0.8)
    finally:
        mcmc._phase = real
    (a1, o1), (a2, o2), (a3, o3) = calls

    def same(a, b):  # the same values, bit for bit
        return torch.equal(a, b)

    assert [a[5] for a in (a1, a2, a3)] == [True, True, False]
    assert all(all(same(t, u) for t, u in zip(a[2], p))
               for a, p in zip((a1, a2, a3), phases))
    torch.testing.assert_close(a1[3], torch.full((C,), 0.1,
                                                 dtype=torch.float64))
    torch.testing.assert_close(a1[4], torch.ones(d, dtype=torch.float64))
    want_mass = np.maximum(np.var(o1[0][:, 10:].numpy().reshape(-1, d),
                                  axis=0), 1e-8)
    np.testing.assert_allclose(inv_mass.numpy(), want_mass, rtol=1e-14)
    for args in (a2, a3):
        assert same(args[4], inv_mass)
    assert same(a2[1], o1[1]) and same(a2[3], o1[2])
    assert same(a3[1], o2[1]) and same(a3[3], o2[2])
    assert (same(samples, o3[0]) and same(eps, o2[2])
            and same(accept, o3[3]))
    assert samples.shape == (C, 30, d)


def test_hmc_matches_conjugate_posterior():
    """tests/test_mcmc.py:26-35's oracle at a size that runs in seconds
    (4 chains x 600 draws after 200 warmup transitions): the mean within
    0.01, the covariance within rtol 0.1 + atol 0.002, the acceptance in
    (0.5, 1) and R-hat < 1.01."""
    x, y = _conjugate_data()
    model = linear_regression_model(x, y)
    gt = pt.hmc_ground_truth(model, generator=torch.Generator().manual_seed(0),
                             n_samples=600, n_warmup=200, device='cpu')
    np.testing.assert_allclose(gt['mean'], model.true_mean, atol=0.01)
    np.testing.assert_allclose(gt['cov'], model.true_cov, rtol=0.1,
                               atol=0.002)
    diag = gt['diagnostics']
    assert 0.5 < diag['accept_rate'] < 1.0
    assert diag['r_hat'].max() < 1.01


def test_hmc_sample_output_contract():
    """tests/test_mcmc.py:115-127's contract."""
    x, y = _conjugate_data()
    model = linear_regression_model(x, y)
    out = pt.hmc_sample(model.log_prob, np.zeros(model.dim),
                        generator=torch.Generator().manual_seed(4),
                        n_samples=200, n_warmup=200, n_chains=3,
                        device='cpu')
    assert out['samples'].shape == (3, 200, model.dim)
    assert out['mean'].shape == (model.dim,)
    assert out['cov'].shape == (model.dim, model.dim)
    assert out['step_size'].shape == (3,)
    assert out['inv_mass'].shape == (model.dim,)
    assert np.all(out['step_size'] > 0)
    assert np.all(np.isfinite(out['samples']))
    assert isinstance(out['accept_rate'], float)
    assert out['samples'].dtype == np.float64


def test_hmc_unconverged_raises():
    """Chains stuck in far-separated modes trip the R-hat gate
    (tests/test_mcmc.py:96-113)."""
    def log_prob(x):
        x0 = torch.atleast_2d(x)[:, 0]
        lp = torch.logaddexp(-0.5 * (x0 - 100.0) ** 2,
                             -0.5 * (x0 + 100.0) ** 2)
        return lp[0] if x.dim() == 1 else lp

    model = Model(log_prob, 1, 'two_islands')
    with pytest.raises(RuntimeError, match='R-hat'):
        pt.hmc_ground_truth(model, generator=torch.Generator().manual_seed(0),
                            n_samples=200, n_warmup=200, n_chains=6,
                            init_jitter=100.0, device='cpu')


def test_hmc_mesh_raises():
    """A mesh without a chain axis, or whose chain axis does not divide
    the chains, raises (the chain-sharded run itself is held to the
    unsharded one in tests/test_torch_parallel.py)."""
    from viabel_tpu_torch import parallel
    model = robust_regression_model()
    with pytest.raises(ValueError, match='mesh'):
        pt.hmc_sample(model.log_prob, np.zeros(2), device='cpu',
                      mesh=parallel.make_mesh(('sample',),
                                              devices=['cpu'] * 2))
    with pytest.raises(ValueError, match='mesh'):
        pt.hmc_sample(model.log_prob, np.zeros(2), device='cpu',
                      n_chains=3, mesh=parallel.make_mesh(
                          ('chain',), devices=['cpu'] * 2))


def test_host_density_runs_eagerly_and_matches_the_torch_model():
    """A host-side density (the native robust regression) runs the eager
    body (`hmc_sample` counts eager transitions only, and the graph is
    refused for it), and on the same draws its phases equal the torch
    model's: 16 adaptive transitions (see the note above
    `test_phase_matches_jax_hmc_phase`) and 100 sampling ones, rtol
    1e-9."""
    try:
        build_native_library()
    except RuntimeError:
        pytest.skip('no C++ toolchain available')
    native = native_robust_regression_log_density()
    model = robust_regression_model()
    mcmc.reset_counts()
    out = pt.hmc_sample(native, np.zeros(2),
                        generator=torch.Generator().manual_seed(3),
                        n_samples=40, n_warmup=40, n_chains=2, device='cpu')
    assert mcmc.transitions == {'eager': 80, 'replayed': 0}
    assert np.all(np.isfinite(out['samples']))
    g = torch.Generator().manual_seed(4)
    q0 = torch.randn((3, 2), generator=g, dtype=torch.float64)
    eps = torch.tensor([0.1, 0.05, 0.2], dtype=torch.float64)
    mass = torch.tensor([0.3, 0.6], dtype=torch.float64)
    for adapt, n in ((True, 16), (False, 100)):
        draws = mcmc._phase_draws(g, n, 3, 2, 32, torch.float64)
        got, want = (mcmc._phase(f, q0, draws, eps, mass, adapt, 0.8, 32)
                     for f in (native, model.log_prob))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                       atol=1e-12)
    with pytest.raises(ValueError, match='host-side log density'):
        mcmc._phase(native, q0, draws, eps, mass, True, 0.8, 32,
                    driver='graph')
