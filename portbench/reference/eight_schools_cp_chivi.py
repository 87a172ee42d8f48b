"""Eight schools, centred, under a mean-field Student-t(40) q fitted by
CHIVI from the notebook's start: the density and the family of
`eight_schools_cp_mft40`, and the configuration's own ``init``."""
import numpy as np

from portbench.reference.eight_schools_cp_mft40 import (  # noqa: F401
    Target, family)


def init(cfg):
    """q's starting parameters as the configuration lists them: ``[mean,
    0.5 log diag cov]`` of the HMC ground truth's moments."""
    return np.asarray(cfg['init'], dtype=np.float64)
