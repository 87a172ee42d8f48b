"""The port's full-rank families, Cholesky densities and gamma-based
samplers against viabel_tpu at float64.

Densities, transforms, entropies and moments take the same numpy-made
inputs in both packages and agree to 1e-12 relative (a few roundings of
float64 arithmetic in different orders); the ill-conditioned factor is
held to 1e-8, since the triangular inverse both packages take loses digits
in proportion to the factor's condition number (1e4 here).  The samplers
of a non-integer or large df draw from another generator than the JAX
package, so they are held by KS tests against the exact distribution, as
tests/test_distributions.py holds the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.stats as sps
from scipy.special import gammaln
import torch

import viabel_tpu as vt
import viabel_tpu.distributions as jd
import viabel_tpu_torch as pt
import viabel_tpu_torch.distributions as td
from viabel_tpu.families import _unpack_chol as j_unpack
from viabel_tpu_torch import interop
from viabel_tpu_torch.families import _unpack_chol as t_unpack

RTOL = 1e-12
D = 4


def _chol(rng, d, cond=None):
    L = np.tril(rng.normal(0, 0.4, (d, d)), -1) + np.diag(
        rng.uniform(0.5, 1.5, d))
    if cond is not None:
        L[np.diag_indices(d)] = np.geomspace(1.0, 1.0 / cond, d)
    return L


@pytest.mark.parametrize('cond', [None, 1e4])
@pytest.mark.parametrize('kind', ['mvn', 'mvt'])
def test_cholesky_densities_match_jax(kind, cond):
    rng = np.random.default_rng(0 if cond is None else 1)
    L, mean = _chol(rng, D, cond), rng.normal(size=D)
    x = rng.normal(size=(300, D)) * 2.0
    if kind == 'mvn':
        want = jd.mvn_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                  jnp.asarray(L))
        got = td.mvn_logpdf_chol(torch.as_tensor(x), torch.as_tensor(mean),
                                 torch.as_tensor(L))
    else:
        want = jd.mvt_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                  jnp.asarray(L), 7.5)
        got = td.mvt_logpdf_chol(torch.as_tensor(x), torch.as_tensor(mean),
                                 torch.as_tensor(L), 7.5)
    rtol = RTOL if cond is None else 1e-8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)
    # and the density itself, by a triangular solve over the samples
    maha = np.sum(scipy.linalg.solve_triangular(L, (x - mean).T,
                                                lower=True) ** 2, axis=0)
    log_det = 2 * np.sum(np.log(np.diag(L)))
    if kind == 'mvn':
        exact = -0.5 * (maha + log_det + D * np.log(2 * np.pi))
    else:
        nu = 7.5
        exact = (gammaln(0.5 * (nu + D)) - gammaln(0.5 * nu)
                 - 0.5 * D * np.log(np.pi * nu) - 0.5 * log_det
                 - 0.5 * (nu + D) * np.log1p(maha / nu))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-8)


def test_cholesky_density_takes_no_solve_over_the_samples(monkeypatch):
    """One (d, d) triangular solve against the identity, whatever the
    number of samples (viabel_tpu/distributions.py:146-156): a solve over
    the sample axis would pass the (d, n) deviations as its right-hand
    side."""
    seen = []
    solve = torch.linalg.solve_triangular

    def spy(A, B, **kw):
        seen.append(tuple(B.shape))
        return solve(A, B, **kw)

    monkeypatch.setattr(torch.linalg, 'solve_triangular', spy)
    L = torch.as_tensor(_chol(np.random.default_rng(2), D))
    x = torch.randn(1000, D, dtype=torch.float64)
    td.mvn_logpdf_chol(x, torch.zeros(D, dtype=torch.float64), L)
    td.mvt_logpdf_chol(x, torch.zeros(D, dtype=torch.float64), L, 5.0)
    assert seen == [(D, D), (D, D)]


@pytest.mark.parametrize('df', [None, np.inf, 6.0])
@pytest.mark.parametrize('rank', [D, D - 1])
def test_multivariate_t_logpdf_matches_jax(df, rank):
    """The eigh pseudo-inverse, also of a rank-deficient scale, and the
    normal density for df infinite or None."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(D, rank))
    S = A @ A.T
    m, x = rng.normal(size=D), rng.normal(size=(50, D))
    kw = {} if df is None else dict(df=df)
    want = jd.multivariate_t_logpdf(jnp.asarray(x), jnp.asarray(m),
                                    jnp.asarray(S), **kw)
    got = pt.multivariate_t_logpdf(torch.as_tensor(x), torch.as_tensor(m),
                                   torch.as_tensor(S), **kw)
    assert np.all(np.isfinite(got.numpy()))
    # eigh of a rank-deficient S rounds its zero eigenvalues differently in
    # the two packages' LAPACK calls; both drop them, the rest agree
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-9 if rank < D else RTOL)
    one = pt.multivariate_t_logpdf(torch.as_tensor(x[0]), torch.as_tensor(m),
                                   torch.as_tensor(S), **kw)
    assert one.shape == (1,)


FAMILIES = [
    ('full_rank_gaussian',
     lambda m: m.full_rank_gaussian_variational_family(D)),
    ('full_rank_t', lambda m: m.t_variational_family(D, 40)),
    ('full_rank_t_df3', lambda m: m.t_variational_family(D, 3)),
    ('full_rank_t_df1e6', lambda m: m.t_variational_family(D, 1e6)),
]


def _shared_draws(jf, n, key=1):
    """The JAX family's base draws and the same draws as the port's
    tensors (a dict for the Student-t family)."""
    z = jf.base_sample(jax.random.PRNGKey(key), n, jnp.float64)
    np_z = jax.tree.map(np.asarray, z)
    return z, interop.base_draws(np_z)


@pytest.mark.parametrize('name,make', FAMILIES, ids=[f[0] for f in FAMILIES])
def test_full_rank_family_matches_jax(name, make):
    jf, tf = make(vt), make(pt)
    assert (tf.name, tf.dim, tf.var_param_dim) == (jf.name, jf.dim,
                                                   jf.var_param_dim)
    assert tf.var_param_dim == D * (D + 3) // 2
    vp = np.random.default_rng(0).normal(0, 0.4, tf.var_param_dim)
    jvp, tvp = jnp.asarray(vp), interop.var_param(vp)
    jz, tz = _shared_draws(jf, 500)
    x_j, x_t = jf.transform(jvp, jz), tf.transform(tvp, tz)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL)
    # at df = 1e6 the normalizer is a difference of two log-gammas near
    # 6e6, and the JAX package's float64 gammaln is 1e-9 off math.lgamma
    # there (the port's), so log q is held to 1e-8 absolute
    np.testing.assert_allclose(tf.log_prob(tvp, x_t).numpy(),
                               np.asarray(jf.log_prob(jvp, x_j)),
                               rtol=RTOL, atol=1e-8 if 'df1e6' in name else 0)
    np.testing.assert_allclose(float(tf.entropy(tvp)),
                               float(jf.entropy(jvp)), rtol=RTOL)
    for a, b in zip(tf.mean_and_cov(tvp), jf.mean_and_cov(jvp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    for p in (2, 4):
        if name == 'full_rank_t_df3' and p == 4:  # df <= p: no closed form
            with pytest.raises(pt.NoClosedFormMomentError):
                tf.pth_moment(tvp, p)
            continue
        np.testing.assert_allclose(float(tf.pth_moment(tvp, p)),
                                   float(jf.pth_moment(jvp, p)), rtol=RTOL)
    with pytest.raises(ValueError):
        tf.pth_moment(tvp, 3)
    assert torch.equal(tf.init_param(torch.float64),
                       torch.zeros(tf.var_param_dim, dtype=torch.float64))


@pytest.mark.parametrize('name,make', FAMILIES[:2],
                         ids=[f[0] for f in FAMILIES[:2]])
def test_full_rank_gradients_match_jax(name, make):
    """The gradient of the log density through the Cholesky unpacking
    (the gather that builds L) and of the transform."""
    jf, tf = make(vt), make(pt)
    vp = np.random.default_rng(5).normal(0, 0.4, tf.var_param_dim)
    jz, tz = _shared_draws(jf, 64, key=6)

    def jfun(p):
        x = jf.transform(p, jz)
        return jnp.sum(jf.log_prob(p, x)) + jnp.sum(x ** 2)

    def tfun(p):
        x = tf.transform(p, tz)
        return torch.sum(tf.log_prob(p, x)) + torch.sum(x ** 2)

    want = jax.grad(jfun)(jnp.asarray(vp))
    got = torch.func.grad(tfun)(interop.var_param(vp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def test_cholesky_layout_is_numpy_tril_order():
    """``[mu, log diag L, strict lower L]`` with the strict lower triangle
    in ``np.tril_indices(d, k=-1)`` order, which ``torch.tril_indices(d, d,
    -1)`` walks alike."""
    for d in (1, 2, 5):
        rows, cols = torch.tril_indices(d, d, -1)
        np_rows, np_cols = np.tril_indices(d, k=-1)
        np.testing.assert_array_equal(rows.numpy(), np_rows)
        np.testing.assert_array_equal(cols.numpy(), np_cols)
        vp = np.arange(d * (d + 3) // 2, dtype=float) / 10.0
        mu, L = t_unpack(torch.as_tensor(vp), d)
        j_mu, j_L = j_unpack(jnp.asarray(vp), d)
        np.testing.assert_array_equal(mu.numpy(), np.asarray(j_mu))
        np.testing.assert_array_equal(L.numpy(), np.asarray(j_L))
        np.testing.assert_array_equal(L.numpy()[np_rows, np_cols],
                                      vp[2 * d:])


@pytest.mark.parametrize('d', [1, 4, 30])
def test_unpack_chol_gradient_is_each_entry_once(d):
    """The gradient of ``sum(W * L)`` through `_unpack_chol` is W at each
    strict-lower entry and ``W_ii exp(.)`` at each log-diagonal entry, and
    0 for mu, exactly; under `torch.func.vmap` each row of a batch gets its
    own, as alone (the batched runs' and chains' gradients)."""
    rng = np.random.default_rng(d)
    vp = torch.as_tensor(rng.normal(size=(3, d * (d + 3) // 2)))
    W = torch.as_tensor(rng.normal(size=(d, d)))
    rows, cols = np.tril_indices(d, k=-1)

    def f(p):
        return torch.sum(W * t_unpack(p, d)[1])

    grads = [torch.func.grad(f)(p) for p in vp]
    for p, g in zip(vp, grads):
        assert torch.equal(g[:d], torch.zeros(d, dtype=torch.float64))
        assert torch.equal(g[d:2 * d], torch.diagonal(W) * torch.exp(
            p[d:2 * d]))
        assert torch.equal(g[2 * d:], W[rows, cols])
    assert torch.equal(torch.func.vmap(torch.func.grad(f))(vp),
                       torch.stack(grads))


@pytest.mark.parametrize('make', [
    lambda m: m.full_rank_gaussian_variational_family(3),
    lambda m: m.t_variational_family(3, 10)])
def test_init_from_moments_full_rank(make):
    jf, tf = make(vt), make(pt)
    rng = np.random.default_rng(4)
    A = rng.normal(size=(3, 3))
    cov, mean = A @ A.T + np.eye(3), rng.normal(size=3)
    got = pt.init_from_moments(tf, mean, cov)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(vt.init_from_moments(jf, mean, cov)))
    q_mean, q_cov = tf.mean_and_cov(got)
    scale = 1.0 if tf.name == 'full_rank_gaussian' else 10.0 / 8.0
    np.testing.assert_allclose(q_cov.numpy(), scale * cov, rtol=1e-12)
    np.testing.assert_allclose(q_mean.numpy(), mean, rtol=0)


def test_t_family_draws_are_a_pair_and_sample_is_their_transform():
    fam = pt.t_variational_family(3, 2.5)
    vp = torch.linspace(-1, 1, fam.var_param_dim, dtype=torch.float64)
    draws = fam.base_sample(torch.Generator().manual_seed(4), 100,
                            torch.float64)
    assert set(draws) == {'z', 'chi2'}
    assert draws['z'].shape == (100, 3) and draws['chi2'].shape == (100,)
    a = fam.sample(torch.Generator().manual_seed(4), vp, 100)
    assert torch.equal(a, fam.transform(vp, draws))
    with pytest.raises(ValueError):
        pt.t_variational_family(3, 2)


@pytest.mark.parametrize('df', [2.5, 7.3, 1e6])
def test_gamma_student_t_sample_distribution(df):
    """Non-integer df and df above 200: the gamma sampler's draws are
    Student-t(df) (KS p > 0.005, as tests/test_distributions.py holds the
    JAX package's), in float64 and in float32."""
    for dtype in (torch.float64, torch.float32):
        g = torch.Generator().manual_seed(int(df * 10) % 1000)
        x = td.student_t_sample(g, df, (120000,), dtype)
        assert x.dtype == dtype
        _, p = sps.kstest(x.double().numpy(), sps.t(df).cdf)
        assert p > 0.005, 'KS rejected at df={} (p={})'.format(df, p)


@pytest.mark.parametrize('df', [2.5, 7.3, 1e6])
def test_gamma_chi2_sample_distribution(df):
    g = torch.Generator().manual_seed(int(df * 10) % 1000 + 1)
    x = td.chi2_sample(g, df, (120000,), torch.float64).numpy()
    _, p = sps.kstest(x, sps.chi2(df).cdf)
    assert p > 0.005, 'KS rejected at df={} (p={})'.format(df, p)
    np.testing.assert_allclose(x.mean(), df, rtol=0.05)


def test_integer_df_path_is_unchanged():
    """An integer df up to 200 keeps its rejection-free construction: the
    same generator gives the same draws as a hand-built chi-square
    ``-2 sum log u`` plus the odd df's squared normal."""
    df = 7
    g = torch.Generator().manual_seed(11)
    got = td.chi2_sample(g, df, (50,), torch.float64)
    h = torch.Generator().manual_seed(11)
    prod = torch.ones(50, dtype=torch.float64)
    for _ in range(df // 2):
        prod *= torch.rand(50, generator=h, dtype=torch.float64).clamp_min(
            torch.finfo(torch.float64).tiny)
    want = -2.0 * torch.log(prod) + torch.randn(50, generator=h,
                                                dtype=torch.float64) ** 2
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0)


def test_large_df_t_family_draws():
    """``t_variational_family(k, df=1e6)``, as
    examples/linear_regression_ia.py builds it, draws, and its draws are
    close to the Gaussian family's distribution."""
    fam = pt.t_variational_family(2, 1e6)
    x = fam.sample(torch.Generator().manual_seed(0),
                   torch.zeros(5, dtype=torch.float64), 100000)
    assert torch.isfinite(x).all()
    _, p = sps.kstest(x[:, 0].numpy(), sps.norm().cdf)
    assert p > 0.005
