"""Conjugate Bayesian linear regression at d = 300 (the viabel package's
``data_generator_linear``, https://github.com/jhuggins/viabel): rows of X
from N(0, R) with ``R = (1 - rho) I + rho 11^T``, ``W ~ N(0, alpha^2
I)``, ``Y = X W + N(0, noise_variance)`` from numpy's legacy
``RandomState(seed)``; the posterior of ``beta ~ N(0, prior_std^2 I)``,
``y ~ N(X beta, noise_scale^2)``; q a full-rank Gaussian.  The data is
made here once and handed to both the program and the reference."""
import math

import numpy as np
import torch

from portbench.reference.vi import LOG_2PI, FullRankGaussian


def data(cfg):
    """(X (N, D), Y (N,)) as float64 numpy arrays."""
    N, D = cfg['n_rows'], cfg['dim']
    rs = np.random.RandomState(cfg['data_seed'])
    rho = cfg['rho']
    L = np.linalg.cholesky((1 - rho) * np.eye(D) + rho * np.ones((D, D)))
    X = rs.randn(N, D) @ L.T
    W = cfg['alpha'] * rs.randn(D)
    Y = X @ W + np.sqrt(cfg['noise_variance']) * rs.randn(N)
    return X, Y


def family(cfg):
    return FullRankGaussian(cfg['dim'])


class Target:
    """log p and its gradient through ``A = X^T X``, ``b = X^T y``."""

    def __init__(self, cfg, work, device):
        X, Y = data(cfg)
        self.var = cfg['noise_scale'] ** 2
        self.prior_var = cfg['prior_std'] ** 2
        self.A = torch.as_tensor(X.T @ X, dtype=work, device=device)
        self.b = torch.as_tensor(X.T @ Y, dtype=work, device=device)
        self.yy = float(Y @ Y)
        n, d = X.shape
        self.const = (-n * (0.5 * LOG_2PI + math.log(cfg['noise_scale']))
                      - d * (0.5 * LOG_2PI + math.log(cfg['prior_std'])))

    def log_p(self, x):
        sq = self.yy - 2.0 * (x @ self.b) + torch.sum((x @ self.A) * x,
                                                      dim=-1)
        return (self.const - 0.5 * sq / self.var
                - 0.5 * torch.sum(x * x, dim=-1) / self.prior_var)

    def grad(self, x):
        return (self.b - x @ self.A) / self.var - x / self.prior_var


def init(cfg):
    """q at the prior: mean 0, L = prior_std I."""
    d = cfg['dim']
    return np.concatenate([np.zeros(d), np.full(d, np.log(cfg['prior_std'])),
                           np.zeros(d * (d - 1) // 2)])
