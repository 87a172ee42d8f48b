"""PyTorch log-density models (viabel_tpu/models), with the bridge for
host-side densities (`make_callback_log_density`)."""
from .base import Model
from .external import make_callback_log_density
from .eight_schools import (EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y,
                            eight_schools_cp_model, eight_schools_ncp_model,
                            eight_schools_ncp_to_cp)
from .funnel import funnel_model
from .mixture import normal_mixture_model
from .regression import (data_generator_linear, linear_regression_model,
                         robust_regression_model,
                         robust_regression_notebook_data)

__all__ = [
    'Model',
    'eight_schools_cp_model',
    'eight_schools_ncp_model',
    'eight_schools_ncp_to_cp',
    'funnel_model',
    'normal_mixture_model',
    'EIGHT_SCHOOLS_Y',
    'EIGHT_SCHOOLS_SIGMA',
    'robust_regression_model',
    'robust_regression_notebook_data',
    'linear_regression_model',
    'data_generator_linear',
    'make_callback_log_density',
]
