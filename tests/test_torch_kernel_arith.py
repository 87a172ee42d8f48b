"""The arithmetic that the redesigned CUDA kernels adopted, written in
torch and held against the plain versions on the CPU.

``csrc/bound_pass.cuh`` reassociates what the plain versions compute term
by term: reciprocals of sigma, tau, df and the scales in place of
divisions, the summed ``log sigma``, sums of squares in place of sums of
log densities, one logarithm for two coordinates of the Student-t base, a
chunk's statistics as a butterfly of equal-count Chan merges, the combine
as merges in the thread and butterflies with counts in the working type,
and
Box-Muller with the pair a short last group drops left out.  Box-Muller's
own arithmetic stays the plain version's: ``sincospi`` of twice the
uniform moved the normals by up to 1.8e-6, which the funnel's float32
log-weights amplify past their tolerance.

These are tolerance studies of the reassociations, not tests of the
kernels: no line of the ``.cuh`` runs here, the formulas below are typed
again by hand, and they pass whatever the kernels compute.  They show that
a reassociation can hold the tolerance at the extremes before it is built
on the card.  The kernels themselves are held against the plain versions
only on a GPU, by ``tests/test_torch_kernels.py`` (the cases there that
match: ``test_transform_score_partials_matches_plain`` and
``..._instances_and_alignment`` for the hoisted constants, the paired
Student-t base and the regression by reciprocals;
``test_score_chunks_with_nan_and_underflow`` and
``test_score_chunk_beyond_float32_range_matches_plain`` for the butterfly
of merges; ``test_philox_normal_tiles_match_plain`` for the dropped pair)
and by ``chip_smoke.py``.

Each formula here repeats the kernel's order of operations in float32 and
float64 and must stay inside the kernel's own tolerance against the plain
version (float64 1e-10; float32 lw atol 2e-4 + rtol 2e-6, statistics rtol
2e-5, normals 2e-6) on numpy-seeded inputs that include the extremes:
t(40) draws and |z| up to 1e3, ``log_tau`` in [-20, 5], uniforms at 2^-24,
1 - 2^-24 and 1, a chunk whose weights underflow, a NaN in a chunk, a
ragged chunk.
"""
import math

import numpy as np
import pytest
import torch

from viabel_tpu_torch.models import (data_generator_linear,
                                     eight_schools_cp_model,
                                     eight_schools_ncp_model,
                                     linear_regression_model,
                                     robust_regression_model)
from viabel_tpu_torch.ops import lw_stats as ops
from viabel_tpu_torch.ops import philox

LOG_2PI = math.log(2.0 * math.pi)
DTYPES = [torch.float64, torch.float32]
LW_TOL = {torch.float64: dict(atol=1e-10, rtol=1e-10),
          torch.float32: dict(atol=2e-4, rtol=2e-6)}
STATS_RTOL = {torch.float64: 1e-10, torch.float32: 2e-5}
Z_TOL = {torch.float64: 1e-12, torch.float32: 2e-6}
THREADS, ITEMS, WARPS = 256, 8, 8


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               atol=atol, rtol=rtol)


def _t_draws(rng, n, d, dtype):
    """t(40) base draws with the extremes mixed in: rows scaled up to
    |z| = 1e3 and single coordinates at +-1e3."""
    z = rng.standard_t(40, size=(n, d))
    z[: n // 8] *= rng.uniform(1.0, 300.0, size=(n // 8, 1))
    z[n // 8: n // 4, 0] = rng.choice([-1e3, 1e3], size=n // 4 - n // 8)
    return torch.as_tensor(np.clip(z, -1e3, 1e3), dtype=dtype)


# --------------------------------------------------------------------------
# the eight-schools densities with the launch's constants hoisted
# --------------------------------------------------------------------------

def _schools_prior(mu, log_tau, tau):
    zmu, ts = mu * 0.2, tau * 0.2
    return (-0.5 * (zmu * zmu + LOG_2PI) - math.log(5.0)
            - torch.log(5.0 * math.pi * (1.0 + ts * ts)) + log_tau)


def _schools_sum(ss, sum_log_scale):
    return -0.5 * ss - (0.5 * 8 * LOG_2PI + sum_log_scale)


def _cp_hoisted(x, y, sigma):
    mu, log_tau, theta = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    inv_tau, inv_sigma = 1.0 / tau, 1.0 / sigma
    sum_log_sigma = torch.sum(torch.log(sigma))
    zt = (theta - mu[:, None]) * inv_tau[:, None]
    zy = (y[None, :] - theta) * inv_sigma[None, :]
    return (_schools_prior(mu, log_tau, tau)
            + _schools_sum(torch.sum(zt * zt, dim=1), 8 * torch.log(tau))
            + _schools_sum(torch.sum(zy * zy, dim=1), sum_log_sigma))


def _ncp_hoisted(x, y, sigma):
    mu, log_tau, tt = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    inv_sigma = 1.0 / sigma
    sum_log_sigma = torch.sum(torch.log(sigma))
    zy = (y[None, :] - (mu[:, None] + tau[:, None] * tt)) * inv_sigma[None, :]
    return (_schools_prior(mu, log_tau, tau)
            + _schools_sum(torch.sum(tt * tt, dim=1), 0.0)
            + _schools_sum(torch.sum(zy * zy, dim=1), sum_log_sigma))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', ['cp', 'ncp'])
def test_eight_schools_hoisted_constants_match_plain(name, dtype):
    model = (eight_schools_cp_model() if name == 'cp'
             else eight_schools_ncp_model())
    rng = np.random.RandomState(11)
    n = 4000
    mean = torch.as_tensor(model.true_mean, dtype=dtype)
    scale = torch.as_tensor(np.sqrt(np.diag(model.true_cov)), dtype=dtype)
    x = mean + scale * _t_draws(rng, n, 10, dtype)
    # log_tau over [-20, 5], its ends included
    x[: n // 2, 1] = torch.as_tensor(rng.uniform(-20.0, 5.0, n // 2),
                                     dtype=dtype)
    x[0, 1], x[1, 1] = -20.0, 5.0
    y, sigma = (t.to(dtype) for t in model.kernel_data)
    want = ops.model_log_density_plain(model.kernel, model.kernel_data, x)
    got = (_cp_hoisted if name == 'cp' else _ncp_hoisted)(x, y, sigma)
    assert torch.isfinite(got).all()
    _close(got, want, **LW_TOL[dtype])


# --------------------------------------------------------------------------
# the Student-t base: one logarithm for two coordinates
# --------------------------------------------------------------------------

def _t_base_paired(z, df):
    d = z.shape[1]
    one_plus = 1.0 + z * z * (1.0 / df)
    if d % 2:
        one_plus = torch.cat([one_plus, torch.ones_like(one_plus[:, :1])], 1)
    acc = torch.sum(torch.log(one_plus[:, 0::2] * one_plus[:, 1::2]), dim=1)
    return d * ops.t_lognorm(df) - 0.5 * (df + 1.0) * acc


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('d', [2, 3, 10])
def test_student_t_base_in_pairs_matches_plain(d, dtype):
    z = _t_draws(np.random.RandomState(d), 6000, d, dtype)
    z[-1] = 0.0
    z[-2] = 1e-4  # 1 + z^2 / df rounds to 1 in float32: an absolute error
    got, want = _t_base_paired(z, 40.0), ops._base_logpdf(z, 40.0)
    assert torch.isfinite(got).all()
    _close(got, want, **LW_TOL[dtype])


def test_student_t_pairs_do_not_overflow_where_all_ten_would():
    z = torch.full((1, 10), 1e3, dtype=torch.float32)
    one_plus = 1.0 + z * z / 40.0
    assert torch.isinf(torch.prod(one_plus))
    _close(_t_base_paired(z, 40.0), ops._base_logpdf(z, 40.0),
           **LW_TOL[torch.float32])
    far = torch.full((1, 10), 1e9, dtype=torch.float32)
    _close(_t_base_paired(far, 40.0), ops._base_logpdf(far, 40.0),
           **LW_TOL[torch.float32])


# --------------------------------------------------------------------------
# the regression density by reciprocals
# --------------------------------------------------------------------------

def _regression_hoisted(beta, x, y, df, noise_scale, prior_std):
    inv_noise, inv_prior = 1.0 / noise_scale, 1.0 / prior_std
    n_rows, d = x.shape
    z = (y[None, :] - beta @ x.T) * inv_noise
    if df is None:
        loglik = (-0.5 * torch.sum(z * z, dim=1)
                  - n_rows * (0.5 * LOG_2PI + math.log(noise_scale)))
    else:
        acc = torch.sum(torch.log1p(z * z * (1.0 / df)), dim=1)
        loglik = (n_rows * (ops.t_lognorm(df) - math.log(noise_scale))
                  - 0.5 * (df + 1.0) * acc)
    zb = beta * inv_prior
    return loglik + (-0.5 * torch.sum(zb * zb, dim=1)
                     - d * (0.5 * LOG_2PI + math.log(prior_std)))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('robust', [False, True])
def test_regression_by_reciprocals_matches_plain(robust, dtype):
    if robust:
        model = robust_regression_model()
    else:
        data = data_generator_linear(N=100, D=10, seed=42)
        model = linear_regression_model(data['X'], data['Y'])
    rng = np.random.RandomState(3)
    mean = torch.as_tensor(model.true_mean, dtype=dtype)
    scale = torch.as_tensor(np.sqrt(1.5 * np.diag(model.true_cov)),
                            dtype=dtype)
    beta = mean + scale * torch.as_tensor(
        rng.standard_t(40, size=(3000, model.dim)), dtype=dtype)
    xd, y, df, noise_scale, prior_std = model.kernel_data
    want = ops.model_log_density_plain(model.kernel, model.kernel_data, beta)
    got = _regression_hoisted(beta, xd.to(dtype), y.to(dtype), df,
                              noise_scale, prior_std)
    _close(got, want, **LW_TOL[dtype])


# --------------------------------------------------------------------------
# a chunk's statistics as the kernel's butterfly of Chan merges
# --------------------------------------------------------------------------

def _merge_equal(a, b):
    """Chan's rule for groups of one count: no division, symmetric."""
    count, mean_a, m2_a = a
    _, mean_b, m2_b = b
    delta = mean_b - mean_a
    return (count + count, 0.5 * (mean_a + mean_b),
            (m2_a + m2_b) + delta * delta * (0.5 * count))


def _merge(a, b):
    """Chan's rule with the counts in the working type; an empty b (and an
    empty pair) leaves a; where either mean is infinite the merged mean is
    their sum."""
    na, mean_a, m2_a = a
    nb, mean_b, m2_b = b
    n = na + nb
    safe = torch.where(n > 0, n, torch.ones_like(n))
    delta = mean_b - mean_a
    keep = nb == 0
    chan = torch.where(torch.isinf(mean_a) | torch.isinf(mean_b),
                       mean_a + mean_b, mean_a + delta * (nb / safe))
    mean = torch.where(keep, mean_a, chan)
    m2 = torch.where(keep, m2_a,
                     (m2_a + m2_b) + delta * delta * (na * nb / safe))
    return n, mean, m2


def _merge_any(a, b):
    """The kernel's merge_any: `_merge_equal` where the counts agree, else
    `_merge`."""
    equal = a[0] == b[0]
    return tuple(torch.where(equal, e, g)
                 for e, g in zip(_merge_equal(a, b), _merge(a, b)))


def _butterfly(group, width, equal):
    """xor-shuffle merges over the last axis (lanes); lane 0's result.  In
    the general rule both lanes merge the upper lane's group into the
    lower's, as the kernel orders them."""
    lanes = torch.arange(group[0].shape[-1])
    k = 1
    while k < width:
        other = tuple(t[..., lanes ^ k] for t in group)
        if equal:
            group = _merge_equal(group, other)
        else:
            upper = (lanes & k).bool()
            lo = tuple(torch.where(upper, o, g) for g, o in zip(group, other))
            hi = tuple(torch.where(upper, g, o) for g, o in zip(group, other))
            group = _merge(lo, hi)
        k *= 2
    return tuple(t[..., 0] for t in group)


def _chunk_row_as_kernel(lw, alpha=2.0):
    """One partials row of a chunk of up to 2048 log-weights, in the
    order of K1 and K2: thread t holds items t, t + 256, ...; the max by
    nan-propagating reduction (the e's taken against 0 where it is -inf);
    two passes over a thread's valid values; a full chunk then takes
    equal-count merges, a ragged one the general rule; 32 lanes, then 8
    warps.  K3's threads hold other items (16-byte words); the arithmetic
    is the same."""
    n, dtype = lw.shape[0], lw.dtype
    full = n == THREADS * ITEMS
    pad = torch.full((THREADS * ITEMS,), float('nan'), dtype=dtype)
    pad[:n] = lw
    items = pad.reshape(ITEMS, THREADS).T            # (thread, item)
    ok = (torch.arange(THREADS * ITEMS).reshape(ITEMS, THREADS).T < n)
    m = (torch.full((), float('nan'), dtype=dtype) if torch.isnan(lw).any()
         else lw.max())
    m_e = torch.zeros_like(m) if m == -math.inf else m
    e = torch.exp(items - m_e) ** alpha
    stats = []
    for v in (e, items):
        if full:
            mean = v.sum(dim=1) * (1.0 / ITEMS)
            m2 = ((v - mean[:, None]) ** 2).sum(dim=1)
            count = torch.full((THREADS,), float(ITEMS), dtype=dtype)
        else:  # the same over the valid items; a thread may hold none
            count = ok.sum(dim=1).to(dtype)
            total = torch.where(ok, v, torch.zeros_like(v)).sum(dim=1)
            mean = torch.where(count > 0, total / count.clamp_min(1),
                               torch.zeros_like(count))
            m2 = torch.where(ok, (v - mean[:, None]) ** 2,
                             torch.zeros_like(v)).sum(dim=1)
        group = tuple(t.reshape(WARPS, 32) for t in (count, mean, m2))
        warp = _butterfly(group, 32, full)
        stats.append(_butterfly(tuple(t[None, :] for t in warp), WARPS,
                                full))
    (count, mean_e, m2_e), (_, mean_lw, m2_lw) = stats
    return torch.stack([count[0], m, mean_e[0], m2_e[0], mean_lw[0],
                        m2_lw[0]])


def _chunk_lw(case, dtype):
    rng = np.random.RandomState(5)
    lw = torch.as_tensor(3.0 * rng.randn(THREADS * ITEMS) - 50.0, dtype=dtype)
    if case == 'underflow':   # all weights but one underflow to 0
        lw[1:] -= 1e4
    elif case == 'nan':
        lw[777] = float('nan')
    elif case == 'ragged':
        lw = lw[:3 * THREADS + 17]
    elif case == 'one':
        lw = lw[:1]
    return lw


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['full', 'underflow', 'ragged', 'one'])
def test_chunk_statistics_by_butterfly_match_plain(case, dtype):
    lw = _chunk_lw(case, dtype)
    got = _chunk_row_as_kernel(lw)
    want = ops.lw_partials_plain(lw)[0]
    assert torch.isfinite(got).all()
    rtol = STATS_RTOL[dtype]
    np.testing.assert_array_equal(got[:2].numpy(), want[:2].numpy())
    _close(got[[2, 4]], want[[2, 4]], 0, rtol)
    _close(got[[3, 5]], want[[3, 5]], 1e-30, 100 * rtol)
    # and through the combine, beside a second, ordinary chunk
    other = ops.lw_partials_plain(_chunk_lw('full', dtype) + 1.0)
    _close(ops.combine_partials_plain(torch.cat([got[None], other])),
           ops.combine_partials_plain(torch.cat([want[None], other])),
           0, rtol)


def _combine_as_kernel(partials, alpha=2.0):
    """The combine in combine_rows' order: thread t of 256 holds rows t,
    t + 256, ...; the nan-propagating max; each row rescaled by
    exp(m_b - M)^alpha and merged in the thread (the first row taken as
    is, then `_merge_any`: no division where the counts agree); 32 lanes,
    then 8 warps, by the general rule."""
    rows = partials.shape[0]
    per = -(-rows // THREADS)
    padded = torch.zeros((per * THREADS, 6), dtype=partials.dtype)
    padded[:rows] = partials
    padded = padded.reshape(per, THREADS, 6)   # [i, t] = row t + 256 i
    present = (torch.arange(per * THREADS) < rows).reshape(per, THREADS)
    big_m = partials[:, 1].max()   # NaN propagates
    r = torch.exp(padded[..., 1] - big_m) ** alpha
    groups = [(padded[..., 0], padded[..., 2] * r, padded[..., 3] * r * r),
              (padded[..., 0], padded[..., 4], padded[..., 5])]
    out = []
    for count, mean, m2 in groups:
        acc = (count[0], mean[0], m2[0])
        for i in range(1, per):
            row = (count[i], mean[i], m2[i])
            merged = _merge_any(acc, row)
            acc = tuple(torch.where(present[i], mm, a)
                        for mm, a in zip(merged, acc))
        # threads without a row hold zeros, as the kernel's do
        acc = tuple(torch.where(present[0], a, torch.zeros_like(a))
                    for a in acc)
        warp = _butterfly(tuple(t.reshape(WARPS, 32) for t in acc), 32,
                          False)
        out.append(_butterfly(tuple(t[None, :] for t in warp), WARPS,
                              False))
    (n, mean_e, m2_e), (_, mean_lw, m2_lw) = out
    return torch.stack([big_m, mean_e[0], torch.sqrt(m2_e[0] / n[0]),
                        mean_lw[0], torch.sqrt(m2_lw[0] / n[0])])


def _partials_rows(case, dtype):
    """Partials rows of full chunks (count 2048) and a ragged last one, at
    the shapes the paths reduce (1221 rows at 2.5e6 samples, 489 at 1e6),
    a single row, and 20000 rows (4.1e7 samples, past float32's exact
    integers)."""
    rows = {'one': 1, 'regression': 489, 'eight_schools': 1221,
            'underflow': 1221, 'many': 20000}[case]
    rng = np.random.RandomState(rows)
    count = np.full(rows, 2048.0)
    count[-1] = 1440.0 if rows > 1 else 17.0
    m = -50.0 + rng.randn(rows)
    if case == 'underflow':    # rows whose r_b underflows to 0
        m[100:400] -= 1e4
    mean_e = rng.uniform(0.05, 0.5, rows)
    m2_e = count * mean_e * rng.uniform(0.1, 1.0, rows)
    mean_lw = m - rng.uniform(2.0, 4.0, rows)
    m2_lw = count * rng.uniform(0.5, 2.0, rows)
    return torch.as_tensor(np.stack([count, m, mean_e, m2_e, mean_lw, m2_lw],
                                    axis=1), dtype=dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['one', 'regression', 'eight_schools',
                                  'underflow', 'many'])
def test_combine_rows_as_kernel_match_plain(case, dtype):
    """combine_rows' merges (counts in the working type, merge_equal where
    two counts agree) against the plain combine's tree with float64
    counts."""
    parts = _partials_rows(case, dtype)
    got = _combine_as_kernel(parts)
    assert torch.isfinite(got).all()
    _close(got, ops.combine_partials_plain(parts), 0, STATS_RTOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_combine_rows_as_kernel_propagate_nan(dtype):
    parts = _partials_rows('eight_schools', dtype)
    parts[700, 1:] = float('nan')
    assert torch.isnan(_combine_as_kernel(parts)).all()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['-inf', '-inf ragged', 'all -inf', '+inf',
                                  'both'])
def test_chunk_and_combine_with_infinite_values_match_plain(case, dtype):
    """A chunk holding -inf (also in a ragged chunk, and filling it), +inf
    or both: the butterfly's row and the combine beside an ordinary chunk
    give the plain version's values, inf and NaN in the same places."""
    lw = _chunk_lw('ragged' if case == '-inf ragged' else 'full', dtype)
    if case == 'all -inf':
        lw[:] = -math.inf
    elif case == 'both':
        lw[3], lw[400] = -math.inf, math.inf
    else:
        lw[THREADS + 5] = math.inf if case == '+inf' else -math.inf
    got = _chunk_row_as_kernel(lw)
    want = ops.lw_partials_plain(lw)[0]
    other = ops.lw_partials_plain(_chunk_lw('full', dtype) + 1.0)
    for g, w in ((got, want),
                 (_combine_as_kernel(torch.cat([got[None], other])),
                  ops.combine_partials_plain(torch.cat([want[None], other])))):
        np.testing.assert_array_equal(torch.isnan(g).numpy(),
                                      torch.isnan(w).numpy())
        inf = torch.isinf(w)
        np.testing.assert_array_equal(g[inf].numpy(), w[inf].numpy())
        fin = torch.isfinite(w)
        _close(g[fin], w[fin], 1e-30, 100 * STATS_RTOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_chunk_statistics_propagate_nan(dtype):
    got = _chunk_row_as_kernel(_chunk_lw('nan', dtype))
    assert got[0] == THREADS * ITEMS
    assert torch.isnan(got[1:]).all()


# --------------------------------------------------------------------------
# Box-Muller at the ends of the uniforms, and the pair a short last group
# drops
# --------------------------------------------------------------------------

def _normals_as_kernel(n, d, seed, offset, start, dtype):
    """The kernel's rows: group g computes its second Box-Muller pair only
    where the row keeps column 4 g + 2."""
    s = torch.arange(start, start + n, dtype=torch.int64)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    cols, pairs = [], 0
    for g in range(-(-d // 4)):
        bits = philox.philox4x32((s & 0xFFFFFFFF, g, offset, s >> 32), key)
        cols.extend(philox.box_muller(bits[0], bits[1], dtype))
        pairs += 1
        if 4 * g + 2 < d:
            cols.extend(philox.box_muller(bits[2], bits[3], dtype))
            pairs += 1
    assert pairs == -(-d // 2)      # no pair is computed and then dropped
    return torch.stack(cols[:d], dim=1)


@pytest.mark.parametrize('dtype', DTYPES)
def test_box_muller_at_the_ends_of_the_uniforms(dtype):
    """The kernels keep full-precision log, sqrt and sincos of the rounded
    angle, the plain version's own steps, so the ends of the uniform's
    range are the plain version's: u = 1 gives exactly (0, 0), and
    u = 1 - 2^-24, where log u = -6e-8 must not turn positive, and
    u = 2^-24 give finite normals of the right size."""
    # words whose top 24 bits give u = 1, 1 - 2^-24, 1/2, 2^-23 and 2^-24
    ends = torch.tensor([0, 1 << 8, 1 << 31, 0xFFFFFE00, 0xFFFFFFFF],
                        dtype=torch.int64)
    u = philox.uniform_from_bits(ends, dtype)
    assert u.tolist() == [1.0, 1.0 - 2.0 ** -24, 0.5, 2.0 ** -23, 2.0 ** -24]
    b0, b1 = (t.reshape(-1) for t in torch.meshgrid(ends, ends,
                                                    indexing='ij'))
    z0, z1 = philox.box_muller(b0, b1, dtype)
    assert torch.isfinite(z0).all() and torch.isfinite(z1).all()
    assert (z0[b0 == 0] == 0).all() and (z1[b0 == 0] == 0).all()
    r = torch.sqrt(z0.double() ** 2 + z1.double() ** 2)
    want = np.sqrt(-2.0 * np.log(u.double().numpy()))[:, None].repeat(5, 1)
    tol = Z_TOL[dtype]
    np.testing.assert_allclose(r.numpy(), want.reshape(-1), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('d', [1, 2, 3, 4, 5, 10, 11])
def test_normals_with_the_dropped_pair_skipped_match_plain(d, dtype):
    args = (5000, d, 0x9E3779B97F4A7C15, 3, 2 ** 32 - 2500)
    got = _normals_as_kernel(*args, dtype)
    want = philox.philox_normal_plain(*args, dtype)
    assert got.shape == want.shape == (5000, d)
    assert torch.equal(got, want)
