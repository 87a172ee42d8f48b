"""Several processes (ranks) as one mesh, and the package's cross-rank
traffic.

PyTorch port of viabel_tpu/parallel/distributed.py.  The JAX package's
multi-controller runtime lets each process drive the devices it can
address while a mesh spans them all; here `initialize_distributed` forms
the process group (`torch.distributed`) and records each rank's devices,
so that `parallel.devices()` lists every rank's and a mesh built from them
spans the ranks.  Each rank then runs the shards whose devices it holds,
and the few small results that must cross ranks go through `exchange`:

* a bound pass's statistics rows, one a shard (6 values);
* the PSIS tail candidates, ``n_shards x (tail_len + 1)`` values, and a
  maximum and a sum a shard for the renormalization;
* (d,) and (d, d) moment sums;
* a chain group's outputs (histories, fits);
* whatever `mesh.fetch_global` gathers.

The route follows the backend: NCCL moves tensors on the rank's card;
Gloo, which lacks most CUDA collectives, moves one explicit ``.cpu()`` copy
of the payload.  NCCL refuses two ranks on one card, so ranks that share a
card (or run on the CPU) take Gloo.
"""
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ['initialize_distributed', 'local_device_count', 'process_info',
           'RankDevice', 'rank', 'world_size', 'exchange']


class RankDevice(NamedTuple):
    """A device of the mesh and the rank that drives it."""
    rank: int
    device: torch.device


# the devices of every rank, recorded by initialize_distributed
_state = {'local': None, 'global': None, 'backend': None}


def _initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def world_size():
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if _initialized() else 1


def _default_local_devices(local_rank, local_world):
    """The cards of this rank: an equal share of the host's cards when
    there are at least as many as ranks on the host, else the one card it
    shares with others (``local_rank mod cards``); none without a card."""
    n = torch.cuda.device_count()
    if n == 0:
        return []
    if n >= local_world:
        per = n // local_world
        return [torch.device('cuda', local_rank * per + j)
                for j in range(per)]
    return [torch.device('cuda', local_rank % n)]


def initialize_distributed(init_method=None, world_size=None, rank=None,
                           backend=None, local_devices=None):
    """Join the process group of a multi-rank run and record every rank's
    devices; returns `process_info()`.

    `init_method`, `world_size` and `rank` go to
    `torch.distributed.init_process_group` (default: ``env://`` and the
    ``WORLD_SIZE`` and ``RANK`` that ``torchrun`` sets).  `local_devices`
    lists the devices this rank drives (default: its share of the host's
    cards, by ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` when set, else by
    rank; a device may be listed more than once, e.g. ``['cpu'] * 2``).
    `backend` defaults to NCCL when every rank on the host has a card of
    its own, and to Gloo when ranks share a card or run on the CPU."""
    if init_method is None:
        init_method = 'env://'
    if world_size is None:
        world_size = int(os.environ['WORLD_SIZE'])
    if rank is None:
        rank = int(os.environ['RANK'])
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world_size))
    if local_devices is None:
        local = _default_local_devices(local_rank, local_world)
    else:
        local = [torch.device(d) for d in local_devices]
    if backend is None:
        own_cards = torch.cuda.device_count() >= local_world
        backend = ('nccl' if local and own_cards
                   and all(d.type == 'cuda' for d in local) else 'gloo')
    if backend == 'nccl':
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    gathered = [None] * world_size
    dist.all_gather_object(gathered, [str(d) for d in local])
    _state['local'] = local
    _state['backend'] = backend
    _state['global'] = [RankDevice(r, torch.device(d))
                        for r, names in enumerate(gathered) for d in names]
    return process_info()


def local_device_count():
    """The devices this process drives: its recorded devices after
    `initialize_distributed`, else the cards it sees."""
    if _initialized() and _state['local'] is not None:
        return len(_state['local'])
    return torch.cuda.device_count()


def process_info():
    """``process_index``, ``process_count``, ``global_devices`` and
    ``local_devices`` (viabel_tpu/parallel/distributed.py:40-47)."""
    from .mesh import devices
    return dict(process_index=rank(), process_count=world_size(),
                global_devices=len(devices()),
                local_devices=local_device_count())


def _comm_device():
    """Where this rank's collectives move tensors: its card under NCCL,
    the host under Gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def exchange(rows, owners, shape, dtype, device):
    """Every slot's tensor, in slot order, on `device`, on every rank.

    `owners[i]` is the rank that holds slot i, and `rows` maps each slot
    this rank holds to its tensor (every slot has `shape` and `dtype`).
    Without a process group the rows are only moved to `device`; with
    one, each rank sends a ``(len(owners), *shape)`` buffer holding its own
    slots and reads every slot from its owner's buffer, so each value
    arrives unchanged.  Every rank must make the same calls in the same
    order, as collectives demand."""
    n = len(owners)
    if world_size() == 1:
        return [rows[i].to(device) for i in range(n)]
    comm = _comm_device()
    buf = torch.zeros((n,) + tuple(shape), dtype=dtype, device=comm)
    for i, t in rows.items():
        buf[i].copy_(t)
    bufs = [torch.empty_like(buf) for _ in range(world_size())]
    dist.all_gather(bufs, buf)
    return [bufs[owners[i]][i].to(device) for i in range(n)]
