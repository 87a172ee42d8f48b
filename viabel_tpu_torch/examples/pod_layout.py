"""Multi-device and multi-process recipe (examples/pod_layout.py): the mesh
layouts of `viabel_tpu_torch.parallel`.

Layouts demonstrated (benchmarks/SCALING.md's placement guidance: starts
and rates on ``chain`` first; spill onto ``sample`` only when the bound
stage dominates):

1. the sample-sharded bound pass and PSIS (`sharded_all_bounds` +
   `psislw_sharded`) on an N-way mesh;
2. the 2-D multistart: K starts over ``chain`` x each start's bound pass
   over ``sample`` (`validated_vi_multistart(mesh=)`);
3. IA chains over the ``chain`` axis (`rmsprop_IA_optimize_with_rhat(
   mesh=)`) and HMC chains on it (`hmc_sample(mesh=)`).

``--devices N`` lists the device (the card, or ``--device cpu``) N times,
so one card stands in for N; a mesh entry listed twice runs its shards one
after another.  ``--distributed`` joins a process group first
(`parallel.initialize_distributed`: NCCL when each rank has a card of its
own, else Gloo); run one copy a rank with ``--init-method
tcp://host:port --rank R --nprocs W``.  The JAX example's ``--accel``
(the attached accelerators instead of a virtual CPU pool) and Cloud-TPU
discovery have no counterpart.  It reaches K1 (the regression row model,
d = 2) on each shard, the combine and the adagrad step kernel.

    python -m viabel_tpu_torch.examples.pod_layout [--quick] [--devices 8]
        [--device cpu] [--distributed --init-method URL --rank R
        --nprocs W]
"""
import argparse

import numpy as np
import torch

from ..bounds import family_moment_bounds
from ..families import mean_field_t_variational_family
from ..mcmc import hmc_sample
from ..models import robust_regression_model
from ..objectives import black_box_klvi
from ..optimizers import rmsprop_IA_optimize_with_rhat
from ..parallel import (fetch_global, initialize_distributed, make_mesh,
                        psislw_sharded, sharded_all_bounds)
from ..pipeline import validated_vi_multistart
from ._common import default_generator, resolve_device


def main(argv=None):
    """Every layout on a mesh of ``--devices`` entries (this process's, or
    with ``--distributed`` every rank's), float32.  Returns the printed
    numbers (the JAX example returns None)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--devices', type=int, default=8,
                   help='mesh entries this process lists (its device, '
                        'repeated)')
    p.add_argument('--device', default=None,
                   help='cuda (the default) or cpu')
    p.add_argument('--distributed', action='store_true',
                   help='join a process group first (one process a rank)')
    p.add_argument('--init-method',
                   help='the process group\'s rendezvous, e.g. '
                        'tcp://localhost:29500 (default env://)')
    p.add_argument('--rank', type=int)
    p.add_argument('--nprocs', type=int)
    p.add_argument('--quick', action='store_true',
                   help='tiny sizes (smoke run / test suite)')
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    local = [str(device)] * args.devices
    if args.distributed:
        info = initialize_distributed(args.init_method, args.nprocs,
                                      args.rank, local_devices=local)
        print('process {}/{}: {} global devices'.format(
            info['process_index'] + 1, info['process_count'],
            info['global_devices']))
        mesh_devices = None  # every rank's entries
    else:
        mesh_devices = local

    scale = 0.05 if args.quick else 1.0
    model = robust_regression_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    obj = black_box_klvi(fam, model, 100, presampled=True)
    init = torch.as_tensor(np.concatenate([np.zeros(model.dim),
                                           np.ones(model.dim)]),
                           dtype=torch.float32)
    out = {}

    # 1) the sample-sharded bound pass and PSIS on every entry
    sample_mesh = make_mesh(('sample',), devices=mesh_devices)
    n_dev = sample_mesh.shape['sample']
    vp = init.to(sample_mesh.home())
    n = max(int(40000 * scale), 1024) * n_dev
    res, lw = sharded_all_bounds(
        model, fam, vp, n, default_generator(sample_mesh.home(), 0),
        sample_mesh,
        moment_bound_fn=family_moment_bounds(fam, vp),
        q_var=fam.mean_and_cov(vp)[1].cpu().numpy(),
        return_log_weights=True)
    _, khat = psislw_sharded(lw, sample_mesh)
    print('[1] {}-way sharded bound pass (n = {:.0e}): d2 = {:.3g}, '
          'khat = {:.3f}'.format(n_dev, float(n), res['d2'], float(khat)))
    out['sharded'] = dict(d2=res['d2'], khat=float(khat))

    # 2) the 2-D multistart: starts over chain x bounds over sample
    c = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh2d = make_mesh(('chain', 'sample'), shape=(c, n_dev // c),
                       devices=mesh_devices)
    ms = validated_vi_multistart(
        model, fam, init, max(int(1000 * scale), 50), n_starts=2 * c,
        perturb_scale=0.25, objective_and_grad=obj,
        n_bound_samples=8192 * (n_dev // c),
        generator=default_generator(mesh2d.home(), 1), mesh=mesh2d)
    print('[2] ({}x{}) mesh, {} starts in one program: best start {} '
          '(d2 = {:.3g})'.format(c, n_dev // c, 2 * c, ms['best'],
                                 ms['bounds'][ms['best']]['d2']))
    out['multistart'] = dict(best=ms['best'],
                             d2=ms['bounds'][ms['best']]['d2'])

    # 3) IA chains over the chain axis (the reference's sequential loop,
    # spread over devices)
    n_ia = max(int(500 * scale), 40)
    ia = rmsprop_IA_optimize_with_rhat(
        n_ia, obj, init, model.dim,
        generator=default_generator(mesh2d.home(), 2),
        n_optimisers=c, rhat_window=n_ia // 2, tail_avg_iters=n_ia // 2,
        mesh=mesh2d)
    r_hat = float(np.max(ia[6]['r_hat_mean']))
    print('[3] {} IA chains over the chain axis: final R-hat max = '
          '{:.3f}'.format(c, r_hat))
    out['ia_r_hat_max'] = r_hat

    # 3b) HMC chains on the same chain axis (each layout is deterministic
    # on its own; sharded and unsharded chains differ by design, see
    # hmc_sample)
    n_hmc = max(int(2000 * scale), 100)
    hmc = hmc_sample(model.log_prob, np.zeros(model.dim, dtype=np.float32),
                     generator=default_generator(mesh2d.home(), 3),
                     n_chains=2 * c,
                     n_samples=n_hmc, n_warmup=n_hmc // 2, mesh=mesh2d)
    print('[3b] {} HMC chains over the chain axis: R-hat max = {:.3f}, '
          'accept = {:.2f}'.format(2 * c, float(np.max(hmc['r_hat'])),
                                   hmc['accept_rate']))
    out['hmc'] = dict(r_hat_max=float(np.max(hmc['r_hat'])),
                      accept_rate=hmc['accept_rate'])

    # the host post-passes fetched through fetch_global already; here it
    # is for a user-held sharded array
    host = fetch_global(lw)
    print('    log-weights live on {} mesh entries ({} device(s)); '
          'fetch_global -> host {}'.format(
              sample_mesh.size,
              len({(int(r), str(d)) for r, d in zip(
                  sample_mesh.ranks.flat, sample_mesh.devices.flat)}),
              host.shape))
    out['fetched'] = host.shape
    return out


if __name__ == '__main__':
    main()
