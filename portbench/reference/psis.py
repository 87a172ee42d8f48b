"""Pareto-smoothed importance sampling, plain, after Vehtari, Gelman and
Gabry (arXiv:1507.02646) and their reference code: the largest
``ceil(min(0.2 n, 3 sqrt(n)))`` log-weights get a generalized Pareto fit
by Zhang and Stephens' empirical Bayes quadrature with the weakly
informative prior on k, are replaced by the fit's order-statistic
quantiles, truncated at the largest raw weight, and all are normalized.
Works in the dtype of its input."""
import math

import torch

PRIOR_BS, PRIOR_K = 3.0, 10.0
K_MIN = 1.0 / 3.0


def gpdfit(x):
    """(k, sigma) of the ascending exceedances `x` (n,)."""
    n = x.shape[0]
    m = 30 + int(math.sqrt(n))
    j = torch.arange(1, m + 1, dtype=x.dtype, device=x.device)
    bs = 1.0 - torch.sqrt(m / (j - 0.5))
    bs = bs / (PRIOR_BS * x[int(n / 4 + 0.5) - 1]) + 1.0 / x[-1]
    ks = torch.mean(torch.log1p(-bs[:, None] * x[None, :]), dim=1)
    L = n * (torch.log(-bs / ks) - ks - 1.0)
    w = 1.0 / torch.sum(torch.exp(L[None, :] - L[:, None]), dim=1)
    keep = w >= 10 * torch.finfo(x.dtype).eps
    w, bs = w[keep], bs[keep]
    w = w / torch.sum(w)
    b = torch.sum(bs * w)
    k = torch.mean(torch.log1p(-b * x))
    sigma = -k / b
    k = k * n / (n + PRIOR_K) + PRIOR_K * 0.5 / (n + PRIOR_K)
    return k, sigma


def gpinv(p, k, sigma):
    if abs(float(k)) < 1e-15:
        return -torch.log1p(-p) * sigma
    return torch.expm1(-k * torch.log1p(-p)) / k * sigma


def psislw(lw):
    """(smoothed log-weights, khat) of the log-weights `lw` (n,)."""
    n = lw.shape[0]
    tail = int(math.ceil(min(0.2 * n, 3 * math.sqrt(n))))
    x = lw - torch.max(lw)
    top, idx = torch.topk(x, tail + 1)
    cutoff = max(float(top[tail]), math.log(torch.finfo(x.dtype).tiny))
    keep = top[:tail] > cutoff
    vals, idx = torch.flip(top[:tail][keep], (0,)), torch.flip(
        idx[:tail][keep], (0,))
    n2 = vals.shape[0]
    if n2 <= 4:
        return x - torch.logsumexp(x, dim=0), math.inf
    k, sigma = gpdfit(torch.exp(vals) - math.exp(cutoff))
    out = x.clone()
    if float(k) >= K_MIN and math.isfinite(float(k)):
        p = (torch.arange(n2, dtype=x.dtype, device=x.device) + 0.5) / n2
        out[idx] = torch.log(gpinv(p, k, sigma) + math.exp(cutoff))
        out = torch.clamp(out, max=0.0)
    return out - torch.logsumexp(out, dim=0), float(k)
