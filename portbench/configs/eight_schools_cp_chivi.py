"""The program's objects for eight schools, centred, under a mean-field
Student-t(40) q with presampled CHIVI (its log-norm taken by the
adagrad window, `validated_vi`'s default for a CHIVI objective)."""
import torch

import viabel_tpu_torch as vt
from viabel_tpu_torch.models import eight_schools_cp_model


def build(cfg, init, device):
    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(cfg['dim'], cfg['df'])
    objective = vt.black_box_chivi(cfg['alpha'], fam, model, cfg['n_mc'],
                                   presampled=True)
    return model, fam, torch.as_tensor(init, dtype=torch.float32,
                                       device=device), objective
