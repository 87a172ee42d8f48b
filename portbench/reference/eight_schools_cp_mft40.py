"""Eight schools, centred (Rubin 1981; Gelman et al., BDA 5.5), as the
validated-VI paper fits it (arXiv:1910.04102): ``mu ~ N(0, 5)``, ``tau ~
half-Cauchy(0, 5)`` on ``log tau`` with its log-Jacobian, ``theta_j ~
N(mu, tau)``, ``y_j ~ N(theta_j, sigma_j)``; parameters ``[mu, log tau,
theta_1..8]``; q a mean-field Student-t(40)."""
import math

import numpy as np
import torch

from portbench.reference.vi import LOG_2PI, MeanFieldT

Y = (28., 8., -3., 7., -1., 1., 18., 12.)
SIGMA = (15., 10., 16., 11., 9., 11., 10., 18.)


def family(cfg):
    return MeanFieldT(cfg['dim'], cfg['df'])


class Target:
    def __init__(self, cfg, work, device):
        self.y = torch.tensor(Y, dtype=work, device=device)
        self.sigma = torch.tensor(SIGMA, dtype=work, device=device)

    def log_p(self, x):
        mu, lt, th = x[..., 0], x[..., 1], x[..., 2:]
        tau = torch.exp(lt)
        lp = -0.5 * (mu / 5.0) ** 2 - 0.5 * LOG_2PI - math.log(5.0)
        lp = lp - torch.log(math.pi * 5.0 * (1.0 + (tau / 5.0) ** 2)) + lt
        d = (th - mu[..., None]) / tau[..., None]
        lp = lp + torch.sum(-0.5 * d * d - 0.5 * LOG_2PI, dim=-1) - 8 * lt
        e = (self.y - th) / self.sigma
        return lp + torch.sum(-0.5 * e * e - 0.5 * LOG_2PI
                              - torch.log(self.sigma), dim=-1)

    def grad(self, x):
        mu, lt, th = x[..., :1], x[..., 1:2], x[..., 2:]
        inv_tau2 = torch.exp(-2.0 * lt)
        u = torch.exp(2.0 * lt) / 25.0
        dev = th - mu
        g_mu = -mu / 25.0 + torch.sum(dev, dim=-1, keepdim=True) * inv_tau2
        g_lt = (1.0 - 2.0 * u / (1.0 + u) - 8.0
                + torch.sum(dev * dev, dim=-1, keepdim=True) * inv_tau2)
        g_th = -dev * inv_tau2 + (self.y - th) / self.sigma ** 2
        return torch.cat([g_mu, g_lt, g_th], dim=-1)


def init(cfg):
    """q's starting parameters: zeros."""
    return np.zeros(2 * cfg['dim'])
