"""Pareto-smoothed importance sampling (PSIS).

PyTorch port of viabel_tpu/psis.py:45-257 (Vehtari, Gelman & Gabry 2017,
arXiv:1507.02646).  `psislw` fits a generalized Pareto distribution to the
largest ``min(0.2 n, 3 sqrt(n / Reff))`` log-weights with the
Zhang-Stephens quadrature (`gpdfit`), replaces them by GPD order-statistic
quantiles (`gpinv`), truncates at the max raw weight, renormalizes, and
reports the tail index khat.  The tail comes from `torch.topk` (the
counterpart of ``lax.top_k``); everything stays on the input's device
with no host round trip.  These are plain tensor operations: whether the
tail fit deserves a kernel is a question for measurement.
"""
import numpy as np
import torch

from ._trace import span

__all__ = ['psislw', 'psisloo', 'gpdfit', 'gpinv', 'sumlogs',
           'weighted_moments']

_PRIOR_B = 3.0
_PRIOR_K_A = 10.0
_K_MIN = 1.0 / 3.0


def weighted_moments(samples, slw):
    """Self-normalized importance-weighted mean and covariance of
    ``samples`` (n, d) under log-weights ``slw`` (n,)
    (viabel_tpu/psis.py:45-64).  The products run in full float32 or
    float64: the package forbids TF32 (`_device.fp32_matmul_policy`)."""
    with span('moments', samples.device):
        w = torch.exp(slw - torch.max(slw))
        w = w / torch.sum(w)
        mean = w @ samples
        c = samples - mean[None, :]
        return mean, (w[:, None] * c).T @ c


def _tail_len(n, Reff):
    """Tail length ``ceil(min(0.2 n, 3 sqrt(n / Reff)))``
    (viabel_tpu/psis.py:71-74)."""
    return int(np.ceil(min(0.2 * n, 3 * np.sqrt(n / Reff))))


def gpinv(p, k, sigma):
    """Inverse generalized-Pareto CDF, branch-free
    (viabel_tpu/psis.py:77-85).  Assumes ``0 < p < 1``."""
    small_k = torch.abs(k) < 1e-15
    k_safe = torch.where(small_k, torch.ones_like(k), k)
    base = -torch.log1p(-p)
    x = torch.where(small_k, base, torch.expm1(k_safe * base) / k_safe)
    x = x * sigma
    return torch.where(sigma <= 0, torch.full_like(x, float('nan')), x)


def gpdfit(x2, mask, n2):
    """Zhang-Stephens empirical-Bayes GPD fit on the masked exceedances
    (viabel_tpu/psis.py:92-137).  `x2` is ascending with the valid suffix
    selected by `mask` (`n2` entries, a 0-d integer tensor).  Returns
    ``(k, sigma)`` with the weakly informative prior on k applied."""
    tail_len = x2.shape[0]
    M = 30 + int(np.ceil(np.sqrt(tail_len)))    # static quadrature bound
    dtype = x2.dtype
    n2f = n2.to(dtype)
    m_dyn = 30.0 + torch.floor(torch.sqrt(n2f))
    j = torch.arange(1, M + 1, dtype=dtype, device=x2.device)
    valid_j = j <= m_dyn

    q_pos = (tail_len - n2 + torch.floor(n2f / 4 + 0.5).to(n2.dtype) - 1)
    q_pos = torch.clamp(q_pos, 0, tail_len - 1)
    x_quart = x2[q_pos]
    x_max = x2[-1]

    bs = 1.0 - torch.sqrt(m_dyn / (j - 0.5))
    bs = bs / (_PRIOR_B * x_quart) + 1.0 / x_max      # (M,)

    ks_j = -bs
    x2_safe = torch.where(mask, x2, torch.zeros_like(x2))
    lm = torch.log1p(ks_j[:, None] * x2_safe[None, :])  # (M, tail_len)
    k_j = torch.sum(torch.where(mask[None, :], lm, torch.zeros_like(lm)),
                    dim=1) / n2f

    L = n2f * (torch.log(-bs / k_j) - k_j - 1.0)
    L = torch.where(valid_j, L, torch.full_like(L, -float('inf')))
    w = 1.0 / torch.sum(torch.exp(L[None, :] - L[:, None]), dim=1)
    w = torch.where(valid_j, w, torch.zeros_like(w))
    w = torch.where(w >= 10 * torch.finfo(dtype).eps, w, torch.zeros_like(w))
    w = w / torch.sum(w)

    b_post = torch.sum(bs * w)
    k = torch.sum(torch.where(mask, torch.log1p(-b_post * x2_safe),
                              torch.zeros_like(x2))) / n2f
    sigma = -k / b_post
    k = k * n2f / (n2f + _PRIOR_K_A) + _PRIOR_K_A * 0.5 / (n2f + _PRIOR_K_A)
    return k, sigma


def _psislw_1d(x, tail_len):
    """Smooth one column of log-weights; returns ``(smoothed, khat)``
    (viabel_tpu/psis.py:140-182).  Only the ``tail_len + 1`` largest
    weights are extracted (`torch.topk`) and only the tail is written back.
    Tied weights at the tail boundary may take their quantiles in another
    order than ``lax.top_k`` gives them (equally valid)."""
    with span('psis', x.device):
        dtype = x.dtype
        cutoffmin = float(np.log(torch.finfo(dtype).tiny))

        x = x - torch.max(x)
        top_vals, top_idx = torch.topk(x, tail_len + 1)
        xcutoff = torch.clamp(top_vals[tail_len], min=cutoffmin)
        tail_slice = torch.flip(top_vals[:tail_len], (0,))
        tail_idx = torch.flip(top_idx[:tail_len], (0,))
        mask = tail_slice > xcutoff
        n2 = torch.sum(mask)

        expxcutoff = torch.exp(xcutoff)
        exceedances = torch.exp(tail_slice) - expxcutoff

        k, sigma = gpdfit(exceedances, mask, n2)
        khat = torch.where(n2 <= 4, torch.full_like(k, float('inf')), k)
        do_smooth = (n2 > 4) & (k >= _K_MIN) & torch.isfinite(k)

        pos_in_valid = (torch.arange(tail_len, device=x.device)
                        - (tail_len - n2))
        sti = ((pos_in_valid.to(dtype) + 0.5)
               / torch.clamp(n2, min=1).to(dtype))
        sti = torch.clamp(sti, 1e-12, 1 - 1e-12)
        qq = torch.log(gpinv(sti, k, sigma) + expxcutoff)
        new_tail = torch.where(do_smooth & mask, qq, tail_slice)

        out = x.clone()
        out[tail_idx] = new_tail
        out = torch.where(do_smooth, torch.clamp(out, max=0.0), out)
        out = out - torch.logsumexp(out, dim=0)
        return out, khat


def psislw(lw, Reff=1.0):
    """Pareto-smoothed importance sampling (viabel_tpu/psis.py:185-211).

    ``lw`` (n,) or (n, m) log-weights; returns the smoothed, self-normalized
    log-weights (same shape) and khat (0-d tensor for 1-D input, else
    (m,)).
    """
    lw = torch.as_tensor(lw)
    if lw.dim() not in (1, 2):
        raise ValueError('Argument `lw` must be 1 or 2 dimensional.')
    n = lw.shape[0]
    if n <= 1:
        raise ValueError('More than one log-weight needed.')
    tail_len = _tail_len(n, Reff)
    if lw.dim() == 1:
        return _psislw_1d(lw, tail_len)
    cols = [_psislw_1d(lw[:, j], tail_len) for j in range(lw.shape[1])]
    return (torch.stack([c[0] for c in cols], dim=1),
            torch.stack([c[1] for c in cols]))


def sumlogs(x, axis=None):
    """``log(sum(exp(x)))`` computed stably (viabel_tpu/psis.py:214-216)."""
    x = torch.as_tensor(x)
    if axis is None:
        return torch.logsumexp(x.reshape(-1), dim=0)
    return torch.logsumexp(x, dim=axis)


def psisloo(log_lik, **kwargs):
    """PSIS leave-one-out log predictive densities
    (viabel_tpu/psis.py:219-257).

    ``log_lik`` (n, m) pointwise log-likelihoods of n posterior draws (or
    (n,) for a single term).  Returns ``(loo, loos, ks)``: the float total,
    the numpy LOO terms and the numpy khats, shaped (m,) for 2-D input and
    0-d for 1-D input.
    """
    log_lik = torch.as_tensor(log_lik)
    lw, ks = psislw(-log_lik, **kwargs)
    loos = sumlogs(lw + log_lik, axis=0)
    loos_np = loos.cpu().numpy()
    return float(loos_np.sum()), loos_np, ks.cpu().numpy()
