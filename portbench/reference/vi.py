"""Plain validated VI: the reference that decides a run's `correct`.

Plain PyTorch, written from the method's definition (Huggins et al. 2020,
arXiv:1910.04102; PSIS in `reference.psis`), importing nothing of the
program.  It runs in a `work` dtype: float64 for the reference, a lower
precision for the control (`reference.control`).

The program takes its randomness from a `torch.Generator` whose seed the
benchmark chooses.  The reference takes the same raw draws from a
generator of the same seed and device, by the same calls in the same
order, and works out everything after them again in `work`: the
Student-t draws from the raw normals and uniforms, the transform, the
objective's gradient, the optimizer, the log-weights, their statistics,
the bounds, PSIS and the corrected moments.
"""
import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
# the largest df that the sampler builds from uniforms (the program's
# rule for Student-t draws: z * sqrt(df / chi2), chi2 a sum of -2 log u)
MAX_EXACT_DF = 200


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def start_seed(gen):
    """The 64-bit seed that the multistart entry point draws from its
    generator for each start (two 32-bit words)."""
    hi, lo = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                           generator=gen, device=gen.device).tolist()
    return (hi << 32) | lo


def learning_rates(n_iters, lr, lr_end):
    """The schedule of every iteration: `lr` for the first quarter, a
    harmonic decay over the middle half, `lr_end` for the last quarter."""
    if lr_end is None:
        return [float(lr)] * n_iters
    b = n_iters * lr_end / (2 * (lr - lr_end))
    a = lr * b
    lo, hi = n_iters // 4, 3 * n_iters // 4
    return [float(lr) if i < lo else a / (b + i - lo + 1) if i < hi
            else float(lr_end) for i in range(n_iters)]


def adagrad(grad, init, lrs, window, epsilon):
    """Windowed adagrad from `init` (P,) or (K, P), ``grad(param, i)``
    the objective's gradient at iteration i; returns the mean of the
    iterates over the last quarter of the run."""
    n = len(lrs)
    p = init.clone()
    ring = torch.zeros((window,) + tuple(p.shape), dtype=p.dtype,
                       device=p.device)
    tail, tail_start = torch.zeros_like(p), 3 * n // 4
    for i in range(n):
        g = grad(p, i)
        ring[i % window] = g
        acc = torch.sum(ring[:min(i + 1, window)] ** 2, dim=0)
        p = p - lrs[i] * g / torch.sqrt(epsilon + acc)
        if i >= tail_start:
            tail = tail + p
    return tail / (n - tail_start)


class MeanFieldT:
    """q = m + exp(s) t with independent Student-t(df) coordinates t;
    parameters ``[m (d), s (d)]``, leading batch axes allowed."""

    def __init__(self, dim, df):
        if int(df) != df or not 1 <= df <= MAX_EXACT_DF:
            raise ValueError('the reference takes integer df up to {}'
                             .format(MAX_EXACT_DF))
        self.dim, self.df = dim, int(df)

    def draws(self, gen, n, work, device):
        """(n, d) base draws in `work` on `device`: a normal block, then
        df // 2 uniform blocks (and a normal block for odd df), float32,
        from `gen`."""
        shape, f32 = (n, self.dim), torch.float32
        z = torch.randn(shape, generator=gen, dtype=f32, device=gen.device)
        tiny = torch.finfo(f32).tiny
        chi2 = torch.zeros(shape, dtype=torch.float64, device=gen.device)
        for _ in range(self.df // 2):
            u = torch.rand(shape, generator=gen, dtype=f32,
                           device=gen.device).clamp_min_(tiny)
            chi2 -= 2.0 * torch.log(u.double())
        if self.df % 2:
            z1 = torch.randn(shape, generator=gen, dtype=f32,
                             device=gen.device).double()
            chi2 += z1 * z1
        t = z.double() * torch.sqrt(self.df / chi2)
        return t.to(device, work)

    def split(self, p):
        return p[..., :self.dim], p[..., self.dim:]

    def transform(self, p, t):
        m, s = self.split(p)
        return m[..., None, :] + torch.exp(s)[..., None, :] * t

    def gradient(self, p, t, grad_log_p):
        """Gradient of KLVI's -(entropy + mean log p) at `p` on draws t."""
        m, s = self.split(p)
        g = grad_log_p(self.transform(p, t))
        gm = -torch.mean(g, dim=-2)
        gs = -(1.0 + torch.mean(g * t, dim=-2) * torch.exp(s))
        return torch.cat([gm, gs], dim=-1)

    def log_q(self, p, x):
        m, s = self.split(p)
        df = self.df
        z = (x - m) / torch.exp(s)
        const = (math.lgamma(0.5 * (df + 1)) - math.lgamma(0.5 * df)
                 - 0.5 * math.log(df * math.pi))
        return torch.sum(const - 0.5 * (df + 1) * torch.log1p(z * z / df)
                         - s, dim=-1)

    def cov(self, p):
        return self.df / (self.df - 2) * torch.diag(
            torch.exp(2 * self.split(p)[1]))

    def moments(self, p):
        """Closed-form C2 = E||x - mean||^2 and C4 = E||x - mean||^4."""
        df = self.df
        v = torch.exp(2 * self.split(p)[1])
        c = df / (df - 2)
        return (float(c * v.sum()),
                float(c ** 2 * (2 * (df - 1) / (df - 4) * (v * v).sum()
                                + v.sum() ** 2)))


class FullRankGaussian:
    """q = mu + L z, z standard normal; parameters ``[mu (d), log diag L
    (d), strict lower L (row-major)]``."""

    def __init__(self, dim):
        self.dim = dim
        self._rows, self._cols = torch.tril_indices(dim, dim, -1)

    def draws(self, gen, n, work, device):
        """(n, d) standard normals as drawn, float32 (exact in any wider
        `work`, which its users convert to a block at a time)."""
        z = torch.randn((n, self.dim), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return z.to(device) if work.itemsize >= 4 else z.to(device, work)

    def unpack(self, p):
        d = self.dim
        L = torch.diag(torch.exp(p[d:2 * d]))
        L[self._rows.to(p.device), self._cols.to(p.device)] = p[2 * d:]
        return p[:d], L

    def transform(self, p, z):
        mu, L = self.unpack(p)
        return mu + z @ L.T

    def gradient(self, p, z, grad_log_p):
        mu, L = self.unpack(p)
        g = grad_log_p(mu + z @ L.T)
        G = -(g.T @ z) / z.shape[0]
        d = self.dim
        rows, cols = self._rows.to(p.device), self._cols.to(p.device)
        return torch.cat([-torch.mean(g, dim=0),
                          torch.diagonal(G) * torch.diagonal(L) - 1.0,
                          G[rows, cols]])

    def log_q(self, p, x):
        mu, L = self.unpack(p)
        r = torch.linalg.solve_triangular(L, (x - mu).T, upper=False)
        return (-0.5 * torch.sum(r * r, dim=0)
                - torch.sum(p[self.dim:2 * self.dim])
                - 0.5 * self.dim * LOG_2PI)

    def cov(self, p):
        L = self.unpack(p)[1]
        return L @ L.T

    def moments(self, p):
        S = self.cov(p)
        tr = torch.trace(S)
        return float(tr), float(2 * torch.sum(S * S) + tr * tr)


def lw_stats(lw):
    """log_rescale (the max), the mean and population std of exp(2 (lw -
    max)), and the mean and population std of lw, as floats."""
    top = torch.max(lw)
    r = torch.exp(2.0 * (lw - top))
    return dict(log_rescale=float(top), mean_r=float(torch.mean(r)),
                std_r=float(torch.std(r, correction=0)),
                mean_lw=float(torch.mean(lw)),
                std_lw=float(torch.std(lw, correction=0)))


def bounds(stats, c2, c4, q_cov):
    """The 2-divergence bound with the ELBO as the log-normalizer bound,
    the Wasserstein bounds from the closed-form moments, and the mean,
    std and covariance error bounds (float64 on the host)."""
    cubo = math.log(stats['mean_r']) / 2.0 + stats['log_rescale']
    d2 = 2.0 * (cubo - stats['mean_lw'])
    out = dict(d2=d2)
    d = max(d2, 0.0)
    # log expm1(d), so that a large d2 gives an infinite bound
    log_em1 = (math.log(math.expm1(d)) if d < 700 else d
               + math.log1p(-math.exp(-d))) if d > 0 else -math.inf
    for p in (1, 2):
        cp = c2 if p == 1 else c4
        log_w = math.log(2.0) + (0.5 / p) * (math.log(cp) + log_em1)
        out['W{}'.format(p)] = math.exp(log_w) if log_w < 709 else math.inf
    w2 = out['W2']
    q_cov = np.asarray(q_cov, dtype=float)
    min_std = (math.sqrt(np.linalg.norm(q_cov, 2))
               if np.all(np.isfinite(q_cov)) else math.inf)
    out.update(mean_error=min(out['W1'], w2), std_error=w2,
               cov_error=2.0 * (min_std * w2 + w2 * w2))
    return out


def weighted_moments(x, slw):
    w = torch.exp(slw - torch.max(slw))
    w = w / torch.sum(w)
    mean = w @ x
    c = x - mean
    return mean, (w[:, None] * c).T @ c
