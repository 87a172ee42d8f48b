"""Several devices, and several processes, as one mesh.

PyTorch port of viabel_tpu/parallel (the same names):

* `make_mesh`, `auto_mesh`, `shard_over`, `fetch_global` — a named grid of
  devices (`Mesh`), arrays placed on it (`Sharded`), the command line's
  and the service's placement rule, and the gather of a placed array to
  host numpy on every rank;
* `sharded_bounds` — the bound pass split over the ``sample`` axis: each
  shard draws and scores its samples on its device with the bound pass's
  kernels, and the statistics rows are merged in shard order;
* `sharded_chains` — IA chains, batched runs and HMC chains split over the
  ``chain`` axis, one batch a device group;
* `sharded_psis` — PSIS with only the weight tail gathered;
* `distributed` — the process group (`initialize_distributed`) and the
  small cross-rank payloads (`distributed.exchange`).
"""
from .distributed import (initialize_distributed, local_device_count,
                          process_info)
from .mesh import (Mesh, Sharded, auto_mesh, devices, fetch_global,
                   make_mesh, shard_over)
from .sharded_bounds import (sharded_all_bounds, sharded_bound_psis,
                             sharded_log_weight_stats,
                             sharded_sample_stats)
from .sharded_chains import shard_chain_inputs
from .sharded_psis import (psislw_sharded, psisloo_sharded,
                           sharded_psis_moments)

__all__ = [
    'make_mesh', 'shard_over', 'fetch_global', 'auto_mesh',
    'sharded_log_weight_stats', 'sharded_sample_stats', 'sharded_all_bounds',
    'sharded_bound_psis',
    'shard_chain_inputs',
    'psislw_sharded', 'psisloo_sharded', 'sharded_psis_moments',
    'initialize_distributed', 'local_device_count', 'process_info',
    'Mesh', 'Sharded', 'devices',
]
