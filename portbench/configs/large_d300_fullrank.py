"""The program's objects for the d = 300 conjugate regression under a
full-rank Gaussian q with presampled KLVI; the data is the benchmark's
(`reference.large_d300_fullrank.data`)."""
import torch

import viabel_tpu_torch as vt
from viabel_tpu_torch.models import linear_regression_model

from portbench.reference.large_d300_fullrank import data


def build(cfg, init, device):
    X, Y = data(cfg)
    model = linear_regression_model(X, Y, noise_scale=cfg['noise_scale'],
                                    prior_std=cfg['prior_std'])
    fam = vt.full_rank_gaussian_variational_family(cfg['dim'])
    objective = vt.black_box_klvi(fam, model, cfg['n_mc'], presampled=True)
    return model, fam, torch.as_tensor(init, dtype=torch.float32,
                                       device=device), objective
