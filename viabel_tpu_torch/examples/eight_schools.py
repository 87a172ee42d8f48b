"""Eight-schools workload (examples/eight_schools.py; reference:
notebooks/eight-schools.ipynb): the centred and non-centred hierarchical
models, KLVI against CHIVI with bounds and PSIS khat.

Both experiments start from the ground-truth moments through
`init_from_moments`, as the reference does (cells 10-16).  By default
those are the stored in-repo HMC moments on the models; ``--hmc`` draws
them live with the port's `mcmc.hmc_ground_truth` (8 chains x 20000 NCP
draws mapped to the CP scale).

It reaches K1 (the CP row model at d = 10, the NCP one), K3, the combine
and the adagrad step kernel.

    python -m viabel_tpu_torch.examples.eight_schools [--full] [--hmc]
        [--device cpu]
"""
import torch

from ..experiments import run_experiment
from ..families import init_from_moments, mean_field_t_variational_family
from ..mcmc import hmc_ground_truth
from ..models import (eight_schools_cp_model, eight_schools_ncp_model,
                      eight_schools_ncp_to_cp)
from ._common import default_generator, parser, resolve_device


def _ground_truth(live_hmc, key, device=None):
    """CP- and NCP-scale ground-truth moments: the stored constants on the
    models, or with `live_hmc` one `hmc_ground_truth` run from generator
    `key` (CP moments from the mapped draws, NCP moments from the raw
    draws' diagnostics; R-hat gated inside)."""
    cp_model = eight_schools_cp_model()
    ncp_model = eight_schools_ncp_model()
    if not live_hmc:
        return dict(mean_cp=cp_model.true_mean, cov_cp=cp_model.true_cov,
                    mean_ncp=ncp_model.true_mean,
                    cov_ncp=ncp_model.true_cov)
    cp = hmc_ground_truth(ncp_model, generator=key, n_samples=20000,
                          n_warmup=1000, n_chains=8,
                          transform=eight_schools_ncp_to_cp, device=device)
    print('live HMC: max split R-hat = {:.4f}'.format(
        cp['diagnostics']['r_hat'].max()))
    return dict(mean_cp=cp['mean'], cov_cp=cp['cov'],
                mean_ncp=cp['diagnostics']['mean'],
                cov_ncp=cp['diagnostics']['cov'])


def run(model, init, true_mean, true_cov, n_iters, mc_samples, key, label,
        ref_khats, device=None):
    """`run_experiment` with a mean-field t(40) family from `init`, its
    streams split from generator `key`."""
    fam = mean_field_t_variational_family(model.dim, 40)
    print('\n################ {} ################'.format(label))
    out = run_experiment(
        model, fam, init, true_mean, true_cov,
        learning_rate=.01, learning_rate_end=.001, n_iters=n_iters,
        bound_w2=mc_samples, n_psis_samples=mc_samples,
        verbose=False, plot_contours=False, generator=key, device=device)
    k_klvi = out[4]['psis_results']['khat']
    k_chivi = out[5]['psis_results']['khat']
    print('{}: khat KLVI = {:.3f} (reference {}), '
          'CHIVI = {:.3f} (reference {})'.format(
              label, k_klvi, ref_khats[0], k_chivi, ref_khats[1]))
    return dict(khat_klvi=k_klvi, khat_chivi=k_chivi, out=out)


def main(full=False, n_iters=None, mc_samples=None, live_hmc=False,
         device=None):
    """CP then NCP, float32, on `device` (None: the CUDA card); the
    generators have the JAX example's seeds (42 for HMC, 0 for CP, 1 for
    NCP).  Returns the JAX example's dict."""
    device = resolve_device(device)
    mc = mc_samples or (1000000 if full else 100000)
    truth = _ground_truth(live_hmc, default_generator(device, 42), device)
    print('ground truth (in-repo HMC): mu = {:.2f}, log_tau = {:.2f}'.format(
        truth['mean_ncp'][0], truth['mean_ncp'][1]))

    fam10 = mean_field_t_variational_family(10, 40)
    init_cp = init_from_moments(fam10, truth['mean_cp'],
                                truth['cov_cp']).to(torch.float32)
    init_ncp = init_from_moments(fam10, truth['mean_ncp'],
                                 truth['cov_ncp']).to(torch.float32)

    cp = run(eight_schools_cp_model(), init_cp, truth['mean_cp'],
             truth['cov_cp'], n_iters or (10000 if full else 2000), mc,
             default_generator(device, 0), 'centered (CP)', (0.906, 0.875),
             device)
    ncp = run(eight_schools_ncp_model(), init_ncp, truth['mean_ncp'],
              truth['cov_ncp'], n_iters or (5000 if full else 2000), mc,
              default_generator(device, 1), 'non-centered (NCP)',
              (0.649, 0.552), device)
    return dict(cp=cp, ncp=ncp, truth=truth)


if __name__ == '__main__':
    p = parser(__doc__.splitlines()[0])
    p.add_argument('--hmc', action='store_true',
                   help='resample ground truth with a live HMC run')
    a = p.parse_args()
    main(a.full, live_hmc=a.hmc, device=a.device)
