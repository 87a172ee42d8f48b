"""Chains (optimization replicas) split over the chain axis of a mesh.

PyTorch port of viabel_tpu/parallel/sharded_chains.py.  The chain axis's
entries are device groups: group g holds the chains ``[g C / G, (g + 1) C
/ G)`` and runs them as one batch on its first device (the entry at chain
index g and 0 on the other axes), and the groups' results are gathered in
chain order (`distributed.exchange`).  The IA optimizers, the batched
pipelines and `mcmc.hmc_sample` place their chains or runs this way when
given a mesh.
"""
import torch

from .mesh import Sharded

__all__ = ['shard_chain_inputs', 'chain_groups']


def chain_groups(mesh, n_items, axis='chain'):
    """``[(lo, hi, entry)]``: the items ``[lo, hi)`` of each group of the
    mesh's `axis` and the entry that runs them.  The axis must divide
    `n_items`."""
    g = mesh.shape[axis]
    if n_items % g:
        raise ValueError('the mesh axis size ({}) must divide the number of '
                         'chains ({})'.format(g, n_items))
    per = n_items // g
    return [(k * per, (k + 1) * per, mesh.entry({axis: k}))
            for k in range(g)]


def shard_chain_inputs(inits, keys, mesh, axis='chain'):
    """Per-chain inits ``(n_chains, P)`` split over the mesh's `axis`,
    each group's block on its device (a `Sharded`), and the per-chain
    generators or seeds `keys` cut into the groups' lists
    (viabel_tpu/parallel/sharded_chains.py:15-26)."""
    from .distributed import rank
    inits = torch.as_tensor(inits)
    groups = chain_groups(mesh, inits.shape[0], axis)
    placed = Sharded(mesh, (axis, None), inits.shape, inits.dtype, {})
    for k, (lo, hi, entry) in enumerate(groups):
        if entry.rank == rank():
            placed.blocks[(k,)] = inits[lo:hi].to(entry.device)
    return placed, [list(keys[lo:hi]) for lo, hi, _ in groups]
