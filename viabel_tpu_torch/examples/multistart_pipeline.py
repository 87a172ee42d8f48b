"""Multi-start validated VI (examples/multistart_pipeline.py; no notebook
counterpart): K complete validated-VI runs (optimize, bounds,
PSIS-corrected moments) as one batch, with best-start selection by the
validated 2-divergence bound.

The reference runs its starts one after another in Python
(viabel/vb.py:417-421); `validated_vi_multistart` runs the K optimizers at
once, one batched step and one step-kernel launch an iteration, then each
start's bound pass (K1, the combine) and PSIS.

    python -m viabel_tpu_torch.examples.multistart_pipeline [--full]
        [--n-starts 4] [--device cpu]
"""
import numpy as np
import torch

from ..experiments import print_bounds
from ..families import mean_field_t_variational_family
from ..models import robust_regression_model
from ..pipeline import validated_vi_multistart
from ._common import default_generator, parser, resolve_device


def main(full=False, n_iters=None, mc_samples=None, n_starts=4,
         device=None):
    """`n_starts` starts of mean-field t(40) KLVI on robust regression,
    float32, on `device` (None: the CUDA card), from a generator of seed
    0.  Returns `validated_vi_multistart`'s dict."""
    device = resolve_device(device)
    model = robust_regression_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    init = torch.as_tensor(np.concatenate([np.zeros(model.dim),
                                           np.ones(model.dim)]),
                           dtype=torch.float32)
    out = validated_vi_multistart(
        model, fam, init, n_iters or (5000 if full else 500),
        n_starts=n_starts, perturb_scale=0.25,
        n_bound_samples=mc_samples or (1000000 if full else 20000),
        learning_rate=.01, learning_rate_end=.001,
        generator=default_generator(device, 0), device=device)

    best = out['best']
    print('{} starts; best by validated d2: start {}'.format(
        n_starts, best))
    for k in range(n_starts):
        d2 = out['bounds'][k]['d2']
        print('  start {}: d2 = {:<10.4g} khat = {:.3f}{}'.format(
            k, d2, out['khat'][k], '   <-- best' if k == best else ''))
    print()
    print_bounds(out['bounds'][best])
    mean = np.asarray(out['psis_mean'][best].cpu())
    print('PSIS-corrected mean (best start):', np.round(mean, 4))
    print('true mean:                       ',
          np.round(np.asarray(model.true_mean), 4))
    return out


if __name__ == '__main__':
    p = parser(__doc__.splitlines()[0])
    p.add_argument('--n-starts', type=int, default=4)
    a = p.parse_args()
    main(a.full, n_starts=a.n_starts, device=a.device)
