"""PyTorch log-density models (the ported part of viabel_tpu/models)."""
from .base import Model
from .eight_schools import (EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y,
                            eight_schools_cp_model, eight_schools_ncp_model,
                            eight_schools_ncp_to_cp)

__all__ = [
    'Model',
    'eight_schools_cp_model',
    'eight_schools_ncp_model',
    'eight_schools_ncp_to_cp',
    'EIGHT_SCHOOLS_Y',
    'EIGHT_SCHOOLS_SIGMA',
]
