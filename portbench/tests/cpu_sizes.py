"""Sizes at which the tests drive a whole run of a cell on the CPU."""
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = {
    'es_cp_fit': dict(n_iters=400, n_bound_samples=20000),
    'es_cp_multistart8': dict(n_iters=400, n_bound_samples=20000),
    'es_cp_validate': dict(n_iters=400, n_bound_samples=20000),
    'large_d300_fit': dict(dim=20, n_rows=80, n_iters=1500,
                           n_bound_samples=5000, n_mc=50),
}


def manifest():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def run_small(cell, seed=2 ** 31 + 12345, seconds=0.2):
    from portbench import run
    return run.run(manifest(), cell, seed, seconds, 0, device='cpu',
                   overrides=SMALL[cell])
