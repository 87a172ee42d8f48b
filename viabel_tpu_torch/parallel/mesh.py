"""Device meshes: a named grid of devices, arrays placed on them, and the
placement rule of the command line and the service.

PyTorch port of viabel_tpu/parallel/mesh.py.  A `Mesh` is a grid of
devices with named axes (``mesh.shape[axis]`` its size along one), each
entry driven by one rank (`distributed.initialize_distributed`; one
process drives every entry otherwise).  A device may stand in the grid
more than once, e.g. ``['cpu'] * 8`` or ``['cuda:0'] * 4``: its shards then
run one after another on it, which is how a one-card machine, or the CPU,
runs a mesh's program.  `auto_mesh` never builds such a grid itself.

A `Sharded` is an array placed on a mesh: some of its dims split over mesh
axes (its `spec`, as a ``PartitionSpec``), each block held by the mesh entry
at the block's coordinates on those axes and 0 on the others, and each
process holding the blocks of its own entries.  `fetch_global` gathers one
to host numpy on every rank.
"""
import math
from collections import OrderedDict
from itertools import product

import numpy as np
import torch

from .distributed import RankDevice, exchange, rank

__all__ = ['Mesh', 'Sharded', 'make_mesh', 'devices', 'shard_over',
           'fetch_global', 'auto_mesh']


def devices():
    """The devices of every rank, in rank order: each rank's recorded
    devices after `initialize_distributed`, else this process's cards."""
    from .distributed import _initialized, _state
    if _initialized() and _state['global'] is not None:
        return list(_state['global'])
    return [RankDevice(0, torch.device('cuda', i))
            for i in range(torch.cuda.device_count())]


_all_devices = devices  # the parameters named `devices` below shadow it


def _entry(d):
    """A `RankDevice`; a bare device is this process's."""
    if isinstance(d, RankDevice):
        return d
    return RankDevice(rank(), torch.device(d))


class Mesh:
    """A grid of devices with named axes: `devices` and `ranks` are numpy
    arrays of the grid's shape (the device and its rank at each entry), and
    ``shape[axis]`` is the size along `axis`."""

    def __init__(self, entries, axis_names):
        entries = np.asarray(entries, dtype=object)
        self.axis_names = tuple(axis_names)
        if entries.ndim != len(self.axis_names):
            raise ValueError('{} axis names for a {}-D grid'.format(
                len(self.axis_names), entries.ndim))
        self.devices = np.empty(entries.shape, dtype=object)
        self.ranks = np.empty(entries.shape, dtype=np.int64)
        for idx in np.ndindex(entries.shape):
            self.devices[idx] = entries[idx].device
            self.ranks[idx] = entries[idx].rank
        self.shape = OrderedDict(zip(self.axis_names, entries.shape))
        self.size = int(entries.size)

    def __repr__(self):
        return 'Mesh({}, {})'.format(dict(self.shape),
                                     [str(d) for d in self.devices.flat])

    def entry(self, coords):
        """The `RankDevice` at `coords` ({axis: index}; other axes 0)."""
        idx = tuple(coords.get(a, 0) for a in self.axis_names)
        return RankDevice(int(self.ranks[idx]), self.devices[idx])

    def line(self, axis, at=None):
        """The entries along `axis`, the other axes at `at` ({axis:
        index}, default 0)."""
        at = dict(at or {})
        return [self.entry(dict(at, **{axis: i}))
                for i in range(self.shape[axis])]

    def home(self):
        """Where this rank reduces what it gathers: its first entry of the
        mesh (the mesh's first for a rank that holds none)."""
        mine = [d for d, r in zip(self.devices.flat, self.ranks.flat)
                if r == rank()]
        return mine[0] if mine else self.devices.flat[0]


def make_mesh(axis_names=('chain', 'sample'), shape=None, devices=None):
    """A `Mesh` over `devices` (default: `devices()`, every rank's cards),
    reshaped to `shape`, which defaults to every device on the last axis,
    ``(1, ..., n_devices)`` (viabel_tpu/parallel/mesh.py:10-27).  A device
    may be listed more than once; a bare device (``'cpu'``,
    ``'cuda:0'``, a `torch.device`) is this process's."""
    if devices is None:
        devices = _all_devices()
    entries = [_entry(d) for d in devices]
    n = len(entries)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError('mesh shape {} does not match {} devices'
                         .format(shape, n))
    grid = np.empty(n, dtype=object)
    grid[:] = entries
    return Mesh(grid.reshape(shape), axis_names)


class Sharded:
    """An array placed on `mesh`: dim k split into equal blocks over the
    mesh axis ``spec[k]`` (None: not split).  `blocks` maps the block
    coordinates (one index a split dim) of the blocks this process holds
    to their tensors, each on its entry's device."""

    def __init__(self, mesh, spec, shape, dtype, blocks):
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.mesh, self.spec = mesh, spec
        self.shape, self.dtype = tuple(shape), dtype
        self.blocks = dict(blocks)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def split(self):
        """(dim, axis) of each split dim."""
        return [(k, a) for k, a in enumerate(self.spec) if a is not None]

    def block_shape(self):
        shape = list(self.shape)
        for k, a in self.split:
            shape[k] //= self.mesh.shape[a]
        return tuple(shape)

    def grid(self):
        """Every block's coordinates, in order."""
        return list(product(*(range(self.mesh.shape[a])
                              for _, a in self.split)))

    def holder(self, coords):
        return self.mesh.entry({a: i for (_, a), i in zip(self.split,
                                                           coords)})

    def __repr__(self):
        return 'Sharded(shape={}, spec={}, {} of {} blocks here)'.format(
            self.shape, self.spec, len(self.blocks), len(self.grid()))


def _check_divides(size, n, what):
    if size % n:
        raise ValueError('the mesh axis size ({}) must divide {} ({})'
                         .format(n, what, size))


def shard_over(x, mesh, axis_name, dim=0):
    """`x` (a tensor or array) placed on `mesh`, split over `axis_name`
    along `dim`: a `Sharded` whose blocks this process holds are on their
    devices (viabel_tpu/parallel/mesh.py:30-34)."""
    x = torch.as_tensor(x)
    spec = [None] * x.dim()
    spec[dim] = axis_name
    n = mesh.shape[axis_name]
    _check_divides(x.shape[dim], n, 'dim {} of the array'.format(dim))
    out = Sharded(mesh, spec, x.shape, x.dtype, {})
    for i, part in enumerate(torch.chunk(x, n, dim=dim)):
        holder = out.holder((i,))
        if holder.rank == rank():
            out.blocks[(i,)] = part.to(holder.device).contiguous()
    return out


def _assemble(parts, counts, dims):
    """Concatenate a flat list of blocks (row-major over `counts`) along
    `dims`, the last split dim innermost."""
    if not dims:
        return parts[0]
    inner = int(np.prod(counts[1:])) if len(counts) > 1 else 1
    rows = [_assemble(parts[j * inner:(j + 1) * inner], counts[1:], dims[1:])
            for j in range(counts[0])]
    return torch.cat(rows, dim=dims[0])


def gather_blocks(x, device):
    """Every block of the `Sharded` `x` on `device`, on every rank, in
    `grid` order."""
    grid = x.grid()
    owners = [x.holder(c).rank for c in grid]
    rows = {j: x.blocks[c] for j, c in enumerate(grid) if c in x.blocks}
    return exchange(rows, owners, x.block_shape(), x.dtype, device)


def fetch_global(x):
    """Host numpy of `x` on every rank: a `Sharded` is gathered from its
    holders (an all-gather over ranks when its blocks span them), in block
    order (viabel_tpu/parallel/mesh.py:137-153); a tensor is copied to the
    host; anything else goes through ``np.asarray``."""
    if isinstance(x, Sharded):
        parts = gather_blocks(x, torch.device('cpu'))
        counts = [x.mesh.shape[a] for _, a in x.split]
        dims = [k for k, _ in x.split]
        return _assemble(parts, counts, dims).numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _largest_divisor_leq(n, cap):
    """Largest d <= cap with n % d == 0 (>= 1), by divisor pairs up to
    sqrt(n) (viabel_tpu/parallel/mesh.py:37-57)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if best < d <= cap:
                best = d
            pair = n // d
            if best < pair <= cap:
                best = pair
        d += 1
    return best


def auto_mesh(n_runs=1, n_samples=None, devices=None):
    """The placement of `n_runs` batched pipelines whose bound passes draw
    `n_samples` each, over `devices` (default: every rank's cards), the
    rule the command line and the service share
    (viabel_tpu/parallel/mesh.py:60-134):

    * K > 1 runs: the run axis takes ``C = gcd(K, N)`` devices and the
      remaining ``S = N / C`` shard each run's bound pass (a ``(chain,
      sample)`` mesh);
    * K == 1: every device on the ``sample`` axis.

    A sample axis that `n_samples` does not divide degrades to the largest
    divisor of `n_samples` that fits, on a subset of the devices.  Returns
    ``(mesh, note)``: mesh None (run on one device) with fewer than two
    devices or no placement at all; `note` says what was placed or why not,
    and the caller must show it."""
    if devices is None:
        devices = _all_devices()
    n_dev = len(devices)
    if n_dev <= 1:
        return None, None
    if n_runs == 1:
        s = n_dev
        if n_samples is not None and n_samples % s:
            s = _largest_divisor_leq(n_samples, n_dev)
            if s == 1:
                return None, ('{} bound samples share no factor <= {} '
                              'with the attached devices; running '
                              'single-device (pick a multiple of {})'
                              .format(n_samples, n_dev, n_dev))
            return (make_mesh(axis_names=('sample',), shape=(s,),
                              devices=devices[:s]),
                    '{} bound samples do not divide over all {} devices; '
                    'degraded to {} devices on the sample axis'.format(
                        n_samples, n_dev, s))
        return (make_mesh(axis_names=('sample',), shape=(s,),
                          devices=devices),
                '{} devices on the sample axis'.format(s))
    c = math.gcd(n_runs, n_dev)
    s = n_dev // c
    degraded = False
    if s > 1 and n_samples is not None and n_samples % s:
        s = _largest_divisor_leq(n_samples, s)
        degraded = True
    if c * s == 1:
        return None, ('{} runs share no common factor with the {} '
                      'attached devices and {} bound samples leave no '
                      'usable sample axis; running single-device'.format(
                          n_runs, n_dev, n_samples))
    mesh = make_mesh(axis_names=('chain', 'sample'), shape=(c, s),
                     devices=devices[:c * s])
    used = ('' if c * s == n_dev else
            ' (using {} of the {} attached devices{})'.format(
                c * s, n_dev,
                '; {} bound samples forced the degradation'.format(
                    n_samples) if degraded else ''))
    if s > 1:
        note = ('({}x{}) (chain, sample) mesh: {} runs per device '
                'group, bound passes {}-way sharded{}'.format(
                    c, s, n_runs // c, s, used))
    else:
        note = '{} devices on the chain axis{}'.format(c, used)
    return mesh, note
