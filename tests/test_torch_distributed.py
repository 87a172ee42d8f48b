"""Two ranks as one mesh: the port's multi-device layer across processes.

Two processes join a Gloo process group on the CPU
(`parallel.initialize_distributed`, ``init_method='file://'`` in the
test's own directory, so that parallel test workers never share a port);
each holds ``['cpu'] * 2`` of a 4-entry mesh.  A third process runs the
same work on a one-process mesh of ``['cpu'] * 4``.  The sharded bound
pass, PSIS, a (2, 2) multistart and the IA chains must give the one
process's results bit for bit on both ranks.

Each process has its own time limit of 120 s, and the test kills the
others when one fails or runs out of time, so no case can hang the suite.
The workers are this file run as a script; they import no JAX.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 120
WORKLOADS = ('bounds', 'psislw', 'multistart', 'ia_chains')


def _workloads(pp, pt, torch, devices):
    """Every workload's arrays, gathered to host numpy on this rank."""
    from viabel_tpu_torch.models import funnel_model, robust_regression_model

    out = {}
    mesh = pp.make_mesh(('sample',), devices=devices)
    fam = pt.mean_field_t_variational_family(2, 40)
    vp = torch.tensor([0.1, -0.2, 0.3, 0.6], dtype=torch.float64)
    res, lw = pp.sharded_all_bounds(funnel_model(), fam, vp, 8000, 1234,
                                    mesh, return_log_weights=True)
    out['bounds'] = dict(lw=pp.fetch_global(lw), **{
        k: np.asarray(float(v)) for k, v in res.items()})

    weights = np.random.default_rng(0).standard_normal((8000, 2)) * 1.5
    slw, khat = pp.psislw_sharded(weights, mesh)
    out['psislw'] = dict(slw=pp.fetch_global(slw),
                         khat=pp.fetch_global(khat))

    grid = pp.make_mesh(('chain', 'sample'), shape=(2, 2), devices=devices)
    model = robust_regression_model()
    init = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    ms = pt.validated_vi_multistart(
        model, fam, init, 60, n_starts=2, n_mc_samples=20,
        n_bound_samples=2000, generator=torch.Generator().manual_seed(5),
        device='cpu', mesh=grid)
    out['multistart'] = dict(
        opt_param=ms['opt_param'].numpy(), khat=np.asarray(ms['khat']),
        d2=np.asarray([b['d2'] for b in ms['bounds']]),
        psis_mean=ms['psis_mean'].numpy(),
        lw=pp.fetch_global(ms['log_weights']),
        slw=pp.fetch_global(ms['smoothed_log_weights']))

    chains = pp.make_mesh(('chain',), devices=devices)
    gauss = pt.mean_field_gaussian_variational_family(2)
    obj = pt.black_box_klvi(gauss, model, 20, presampled=True)
    ia = pt.rmsprop_IA_optimize_with_rhat(
        120, obj, torch.zeros(4, dtype=torch.float64), 2,
        generator=torch.Generator().manual_seed(6), n_optimisers=4,
        rhat_window=40, tail_avg_iters=40, device='cpu', mesh=chains)
    out['ia_chains'] = dict(final=ia[0], chains=ia[1], values=ia[4],
                            avg=ia[6]['averaged_variational_param'])
    return out


def _worker(rank, world, init_file, out_file):
    """Run the workloads as `rank` of `world` (1: one process) and save
    them to `out_file`."""
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    torch.set_num_threads(1)
    import viabel_tpu_torch as pt
    import viabel_tpu_torch.parallel as pp

    if world > 1:
        pp.initialize_distributed('file://' + init_file, world, rank,
                                  local_devices=['cpu', 'cpu'])
        devices = pp.devices()
        assert len(devices) == 4 and pp.process_info() == dict(
            process_index=rank, process_count=world, global_devices=4,
            local_devices=2)
    else:
        devices = ['cpu'] * 4
    results = _workloads(pp, pt, torch, devices)
    np.savez(out_file, **{'{}/{}'.format(w, k): v
                          for w, arrays in results.items()
                          for k, v in arrays.items()})
    if world > 1:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two ranks' and the one process's saved results."""
    tmp = tmp_path_factory.mktemp('ranks')
    init = str(tmp / 'init')
    outs = [str(tmp / name) for name in ('rank0.npz', 'rank1.npz',
                                         'single.npz')]
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    args = [(0, 2), (1, 2), (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(w), init,
         out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for (r, w), out in zip(args, outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    except subprocess.TimeoutExpired:
        pytest.fail('a rank ran past {} s'.format(TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out)) for out in outs]


@pytest.mark.parametrize('workload', WORKLOADS)
def test_two_ranks_equal_one_process_bit_for_bit(runs, workload):
    rank0, rank1, single = runs
    keys = [k for k in single if k.startswith(workload + '/')]
    assert keys
    for k in keys:
        for got in (rank0, rank1):
            np.testing.assert_array_equal(got[k], single[k], err_msg=k)
        assert np.all(np.isfinite(single[k])) or workload == 'bounds', k


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
