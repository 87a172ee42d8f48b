"""Funnel-distribution workload (examples/funnel.py; reference:
notebooks/funnel-distribution.ipynb cell 3): `run_experiment`, KLVI
against CHIVI with the bound pass and PSIS, on the 2-D Neal funnel.

It reaches K1 (the funnel row model, d = 2), K3, the combine and the
adagrad step kernel.

    python -m viabel_tpu_torch.examples.funnel [--full] [--device cpu]
"""
import torch

from ..experiments import run_experiment
from ..families import mean_field_t_variational_family
from ..models import funnel_model
from ._common import default_generator, parser, resolve_device


def main(full=False, n_iters=None, mc_samples=None, device=None):
    """KLVI then CHIVI from ``[0, -1, 1, 1]`` in float32 on `device`
    (None: the CUDA card), from a generator of seed 0.  Returns the JAX
    example's dict."""
    device = resolve_device(device)
    model = funnel_model()
    fam = mean_field_t_variational_family(2, 40)
    init = torch.tensor([0.0, -1.0, 1.0, 1.0], dtype=torch.float32)
    out = run_experiment(
        model, fam, init, model.true_mean, model.true_cov,
        learning_rate=.01, learning_rate_end=.001,
        n_iters=n_iters or (10000 if full else 2000),
        bound_w2=mc_samples or (1000000 if full else 100000),
        n_psis_samples=mc_samples or (1000000 if full else 100000),
        verbose=True, plot_contours=False,
        generator=default_generator(device, 0), device=device)
    klvi_khat = out[4]['psis_results']['khat']
    chivi_khat = out[5]['psis_results']['khat']
    print('\nkhat KLVI = {:.3f} (reference 0.768), '
          'CHIVI = {:.3f} (reference 0.894)'.format(klvi_khat, chivi_khat))
    return dict(khat_klvi=klvi_khat, khat_chivi=chivi_khat,
                klvi=out[4], chivi=out[5])


if __name__ == '__main__':
    a = parser(__doc__.splitlines()[0]).parse_args()
    main(a.full, device=a.device)
