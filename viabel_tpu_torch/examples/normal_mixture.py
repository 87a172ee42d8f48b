"""Normal-mixture bounds workload (examples/normal_mixture.py; reference:
notebooks/normal-mixture.ipynb): the bounds alone, no optimization,
log-weights supplied directly.

q = N(0, 5) approximating the bimodal p = 0.5 N(-2, 1) + 0.5 N(2, 1)
(reference cells 2-8).  Three bound configurations: samples only
(empirical moments), with the known q variance and the exact log
normalizer, and with the analytic Gaussian moment bound function
(reference W2 = 6.08 / 4.41 / 2.72, cells 10/12/14), plus the notebook's
own rooted moment input, which reproduces its 2.72 (PARITY.md).  The
bound pass reduces the log-weights with K3 and the combine.

    python -m viabel_tpu_torch.examples.normal_mixture [--full]
        [--device cpu]
"""
import math

import numpy as np
import torch
from scipy.special import factorial2

from ..bounds import all_bounds
from ..experiments import print_bounds
from ._common import default_generator, parser, resolve_device


def main(full=False, device=None, samples=None):
    """The four configurations on ``n`` float32 draws of q (1e6 with
    `full`, else 5e4) from a generator of seed 918 on `device` (None: the
    CUDA card), or on the given `samples` (n,).  Returns the JAX
    example's dict."""
    device = resolve_device(device)
    q_var = 5.0
    n = 1000000 if full else 50000
    if samples is None:
        samples = math.sqrt(q_var) * torch.randn(
            (n,), generator=default_generator(device, 918), device=device)
    else:
        samples = torch.as_tensor(samples, device=device)
    log_q = (-0.5 * samples ** 2 / q_var
             - 0.5 * math.log(2 * math.pi * q_var))
    log_p = torch.logaddexp(-0.5 * (samples + 2) ** 2,
                            -0.5 * (samples - 2) ** 2) \
        - 0.5 * math.log(2 * math.pi) - math.log(2.0)
    log_weights = log_p - log_q

    print('== samples only (reference W2 = 6.08) ==')
    res1 = all_bounds(log_weights, samples)
    print_bounds(res1)

    print('\n== + q_var and log_norm_bound = 0 (reference W2 = 4.41) ==')
    res2 = all_bounds(log_weights, samples, q_var=q_var, log_norm_bound=0)
    print_bounds(res2)

    print('\n== analytic moment bound fn ==')
    # `moment_bound_fn(a)` returns the raw central moment bound
    # E[(x - y)^a]; the notebook supplies its a-th root instead (cell 6),
    # so its "analytic" W2 = 2.72 is not a bound.  The correct moments
    # here, and the notebook's rooted input after them for parity with its
    # published value (PARITY.md)
    mb = lambda order: factorial2(order - 1) * q_var ** (order / 2)
    res3 = all_bounds(log_weights, moment_bound_fn=mb, q_var=q_var)
    print_bounds(res3)
    mb_ref = lambda order: (factorial2(order - 1) ** (1 / order)
                            * np.sqrt(q_var))
    res3_ref = all_bounds(log_weights, moment_bound_fn=mb_ref, q_var=q_var)
    return dict(samples_only=res1, q_var_lnb=res2, analytic_mb=res3,
                analytic_mb_ref_input=res3_ref)


if __name__ == '__main__':
    a = parser(__doc__.splitlines()[0]).parse_args()
    main(a.full, a.device)
