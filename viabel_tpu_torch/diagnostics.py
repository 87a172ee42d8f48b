"""Convergence diagnostics and iterate averaging.

PyTorch port's copy of viabel_tpu/diagnostics.py:26-231.  These run once
per optimization as a host-side post-pass over small (n_chains, n_iters,
P) iterate histories, so they stay plain numpy, as in the JAX package:
the arrays are megabytes, and the windowed and halfway R-hat loops would
issue dozens of tiny device operations for no gain.  The optimizers hand
them host copies of the histories.
"""
import numpy as np

__all__ = [
    'compute_R_hat',
    'compute_R_hat_adaptive',
    'compute_R_hat_adaptive_numpy',
    'compute_R_hat_halfway',
    'effective_sample_size',
    'stochastic_iterate_averaging',
    'compute_posterior_moments',
]

_JITTER = 1e-8


def _split_rhat(chains):
    """Split-half potential scale reduction over (..., n_chains, n_iters, K).

    Each chain is split into two half-chains; between-/within-chain variance
    decomposition gives ``R = sqrt((n-1)/n + B/(nW))``
    (reference: viabel/functions.py:8-31).  Batches over leading axes.
    """
    *lead, n_chains, n_iters, K = chains.shape
    n_half = n_iters // 2
    if n_half < 2:
        # the within-half variance divides by (n_half - 1): fewer than 4
        # iterations would return NaN/inf R-hat and poison downstream
        # convergence gates (same guard as `_ess_batched`)
        raise ValueError('need at least 4 (post-warmup) iterations per '
                         'chain for split R-hat; got {}'.format(n_iters))
    psi = chains[..., :2 * n_half, :].reshape(*lead, n_chains * 2, n_half, K)
    psi_dot_j = psi.mean(axis=-2)                           # (..., 2c, K)
    psi_dot_dot = psi_dot_j.mean(axis=-2, keepdims=True)    # (..., 1, K)
    s_j_2 = (((psi - psi_dot_j[..., :, None, :]) ** 2).sum(axis=-2)
             / (n_half - 1))
    B = (n_half * ((psi_dot_j - psi_dot_dot) ** 2).sum(axis=-2)
         / (n_chains * 2 - 1))
    with np.errstate(invalid='ignore'):
        W = np.nanmean(s_j_2, axis=-2) + _JITTER
    var_hat = (n_half - 1) / n_half + B / (n_half * W)
    return var_hat, np.sqrt(var_hat)


def compute_R_hat(chains, warmup=500):
    """Split R-hat after discarding `warmup` iterations.

    Mirrors the reference (reference: viabel/functions.py:8-31) except that
    an odd post-warmup length drops exactly one trailing iterate (the
    reference drops two due to an off-by-one; reference:
    viabel/functions.py:15-17).  Returns ``(var_hat, R_hat)``, each (K,).
    """
    chains = np.asarray(chains)[:, warmup:, :]
    return _split_rhat(chains)


def compute_R_hat_adaptive(chains, window_size=100):
    """Windowed R-hat: R-hat of each disjoint `window_size` window.

    Returns array (n_windows, K) (reference: viabel/functions.py:44-52).
    """
    chains = np.asarray(chains)
    n_chains, n_iters, K = chains.shape
    n_windows = n_iters // window_size
    if n_windows == 0:
        return np.zeros((0, K))
    windows = chains[:, :n_windows * window_size, :].reshape(
        n_chains, n_windows, window_size, K).transpose(1, 0, 2, 3)
    _, r_hats = _split_rhat(windows)
    return r_hats


# Reference-name alias (reference: viabel/functions.py:44).
compute_R_hat_adaptive_numpy = compute_R_hat_adaptive


def compute_R_hat_halfway(chains, interval=100, start=1000):
    """Growing-prefix ("halfway") R-hat.

    For prefixes ``[: start + (i+1) * interval]`` compute split R-hat with
    warmup equal to half the prefix (reference: viabel/functions.py:54-65).
    Prefix lengths clamp at the chain length, as numpy slicing does in the
    reference.
    """
    chains = np.asarray(chains)
    n_chains, n_iters, K = chains.shape
    n_subchains = n_iters // interval
    if n_subchains == 0:
        return np.zeros((0, K))
    r_hats = []
    for i in range(n_subchains):
        end = min(start + (i + 1) * interval, n_iters)
        sub = chains[:, :end, :]
        _, r = compute_R_hat(sub, warmup=sub.shape[1] // 2)
        r_hats.append(r)
    return np.asarray(r_hats)


def _autocovariance_fft(x):
    """Per-chain autocovariance function via FFT, biased (1/n) normalization.

    `x` is (n_chains, n_iters); returns (n_chains, n_iters) with lag along
    the last axis.
    """
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n].real
    return acov / n


def effective_sample_size(chains):
    """Effective sample size per parameter (Geyer initial monotone sequence).

    `chains` is ``(n_chains, n_iters)`` or ``(n_chains, n_iters, K)``.
    Returns a scalar (or ``(K,)`` array): the ESS of the pooled draws,
    computed with the multi-chain combined autocorrelation
    ``rho_t = 1 - (W - mean_chain_acov_t) / var_plus`` summed over Geyer
    pairs until the first negative pair, then enforced monotone
    (Vehtari, Gelman, Simpson, Carpenter & Burkner 2021, the Stan/arviz
    estimator).

    The reference has no ESS utility, but its PSIS consumes one:
    ``psislw(lw, Reff)`` takes the relative efficiency ``N_eff / N`` of the
    draws (reference: notebooks/psis.py:112-155, via `psisloo`'s MCMC
    use case).  ``Reff = effective_sample_size(chains) / (n_chains *
    n_iters)`` closes that loop in-repo; the full wiring — HMC draws from
    `viabel_tpu.mcmc` -> ESS -> ``psisloo(log_lik, Reff=...)`` — is
    exercised in tests/test_psis.py::test_ess_reff_closes_the_psis_loop.
    """
    chains = np.asarray(chains, dtype=float)
    if chains.ndim == 2:
        return float(_ess_batched(chains[None, :, :])[0])
    # one batched FFT pass over all K columns: (n_chains, n, K) -> (K, c, n)
    return _ess_batched(np.moveaxis(chains, -1, 0))


def _ess_batched(chains):
    """ESS over a (K, n_chains, n_iters) batch; returns (K,)."""
    K, n_chains, n = chains.shape
    if n < 4:
        raise ValueError('need at least 4 iterations per chain')
    acov = _autocovariance_fft(chains)               # (K, n_chains, n)
    chain_means = chains.mean(axis=-1)               # (K, n_chains)
    acov0 = acov[..., 0].mean(axis=-1)               # (K,)
    # within-chain variance (unbiased) and the pooled posterior-variance
    # estimate var_plus = W * (n-1)/n + B/n
    W = acov0 * n / (n - 1)
    B = (np.var(chain_means, axis=-1, ddof=1) if n_chains > 1
         else np.zeros(K))
    var_plus = acov0 + B
    ok = var_plus > 0                # constant chains: no autocorrelation
    safe_var_plus = np.where(ok, var_plus, 1.0)
    # combined autocorrelation: biased per-chain acov means at each lag,
    # with only the lag-0 within-chain variance W unbiased (the standard
    # Stan/arviz formulation).  rho_0 is hard-coded to 1 exactly as
    # Stan/arviz do — applying the combined formula at lag 0 gives
    # 1 - (W - acov0)/var_plus < 1, which underestimates tau and inflates
    # every ESS by ~2(W - acov0)/var_plus (about 1 % high on 4x200 iid
    # chains, growing as n shrinks)
    rho = 1.0 - (W[:, None] - acov.mean(axis=1)) / safe_var_plus[:, None]
    rho[:, 0] = 1.0
    # Geyer pairs P_k = rho_{2k} + rho_{2k+1}: keep the initial positive
    # sequence (truncate at the first non-positive pair), force it monotone
    # non-increasing, then tau = -1 + 2 * sum_k P_k
    n_pairs = n // 2
    pairs = rho[:, 0:2 * n_pairs:2] + rho[:, 1:2 * n_pairs:2]  # (K, n_pairs)
    nonpos = pairs <= 0
    trunc = np.where(nonpos.any(axis=1), np.argmax(nonpos, axis=1), n_pairs)
    keep = np.arange(n_pairs)[None, :] < trunc[:, None]
    # +inf outside the kept prefix leaves the running minimum untouched;
    # those lags are then zeroed out of the sum
    mono = np.minimum.accumulate(np.where(keep, pairs, np.inf), axis=1)
    tau = np.maximum(-1.0 + 2.0 * np.where(keep, mono, 0.0).sum(axis=1),
                     1.0 / np.log10(n + 1))
    return np.where(ok, n_chains * n / tau, float(n_chains * n))


def stochastic_iterate_averaging(estimate, start):
    """Running (Polyak/SWA-style) average of iterates from `start`.

    Returns the full trajectory of running averages plus the final mean
    (reference: viabel/functions.py:68-77; the reference's
    ``raise "string"`` on an invalid start — functions.py:71 — is replaced
    with a proper ValueError).
    """
    estimate = np.asarray(estimate)
    N = estimate.shape[0]
    if N - start <= 0:
        raise ValueError('start of stationary distribution must be lower '
                         'than number of iterates')
    window_lengths = (np.arange(start, N) - start + 1).reshape(-1, 1)
    estimate_iters = np.cumsum(estimate[start:, :], axis=0) / window_lengths
    estimate_mean = estimate_iters[-1]
    return estimate_iters, estimate_mean


def compute_posterior_moments(prior_mean, prior_covariance, noise_variance,
                              x, y):
    """Exact conjugate Bayesian linear-regression posterior (mean, cov).

    Ground-truth oracle for diagnostics experiments
    (reference: viabel/functions.py:139-150), computed via inverses of the
    Cholesky factors (triangular, well-conditioned) rather than direct
    inversion of the covariance/precision matrices.
    """
    prior_mean = np.asarray(prior_mean)
    prior_covariance = np.asarray(prior_covariance)
    x = np.asarray(x)
    y = np.asarray(y)
    prior_L = np.linalg.cholesky(prior_covariance)
    inv_L = np.linalg.inv(prior_L)
    prior_precision = inv_L.T @ inv_L
    S_precision = prior_precision + x.T @ x * (1.0 / noise_variance)
    a = np.linalg.cholesky(S_precision)
    inv_a = np.linalg.inv(a)
    post_S = inv_a.T @ inv_a
    post_mu = prior_precision @ prior_mean + (1.0 / noise_variance) * x.T @ y
    post_mu = post_S @ post_mu
    return post_mu, post_S
