"""Checkpoint and resume for optimization runs.

PyTorch port of viabel_tpu/checkpoint.py: atomic save and restore of a
dict (or list or tuple) of tensors, arrays and scalars as one ``.npz``
(written to a temporary file, then renamed), and a resumable windowed
adagrad that checkpoints every `save_every` iterations and picks up where
it left off.

A checkpoint's entries are named as the JAX package names a pytree's
leaves: ``leaf_<i>:<path>``, dict keys sorted and joined by ``/``, so both
packages write the same entry names and each reads the other's files
(`checkpoint_format`, `load_checkpoint_entry`).  One entry differs: the
PRNG key.  The JAX package stores its key's ``uint32`` data; the port
stores the generator's state at the start of the call
(``generator.get_state()``, ``uint8``), one row a chain for the chain
runs, and a resume compares it byte for byte.
"""
import os
import tempfile

import numpy as np
import torch

from ._device import default_generator, resolve_device
from .optimizers import (_advance, _learning_rates, _run_draws, _source,
                         _wrap_objective)
from .ops.adagrad import host_state, restore_state

__all__ = ['save_checkpoint', 'load_checkpoint', 'load_checkpoint_entry',
           'checkpoint_format', 'adagrad_optimize_resumable']

# Explicit checkpoint format ids, the JAX package's
# (viabel_tpu/checkpoint.py:43-48): every writer stamps one into a `format`
# entry and every reader dispatches on it through `checkpoint_format`.
FORMAT_ADAGRAD_HISTORY = 'adagrad-history/v1'  # full (n_iters, P) history
FORMAT_ADAGRAD_TAIL = 'adagrad-tail/v1'        # return_history=False mode
FORMAT_CHAINS = 'chains/v1'                    # segmented multichain IA
CHECKPOINT_FORMATS = (FORMAT_ADAGRAD_HISTORY, FORMAT_ADAGRAD_TAIL,
                      FORMAT_CHAINS)


def checkpoint_format(path):
    """The explicit format id of a checkpoint file, or ``None`` for a plain
    parameter-vector ``.npz`` that is not an optimizer checkpoint
    (viabel_tpu/checkpoint.py:51-80).  Checkpoints without a ``format``
    entry fall back to the JAX package's legacy entry-name rules; an
    unknown explicit id is an error."""
    names = _stored_entry_names(path)
    if 'format' in names:
        fmt = str(load_checkpoint_entry(path, 'format'))
        if fmt not in CHECKPOINT_FORMATS:
            raise ValueError(
                'checkpoint {!r} declares format {!r}, which this version '
                'does not know (known: {}); it was likely written by a '
                'newer version'.format(path, fmt,
                                       ', '.join(CHECKPOINT_FORMATS)))
        return fmt
    if 'hist' in names:
        return FORMAT_CHAINS
    if 'params' in names and 'i' in names:
        return FORMAT_ADAGRAD_HISTORY
    if 'tail_sum' in names and 'i' in names and 'values' in names:
        return FORMAT_ADAGRAD_TAIL
    return None


def _flatten(tree, path=()):
    """``[(path, leaf)]`` in the JAX package's pytree order: dict keys
    sorted, list and tuple items in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """`like`'s structure (dict keys sorted) with its leaves taken in order
    from the iterator `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, tree):
    """Atomically save a dict (or list or tuple) of tensors, arrays and
    scalars to `path` (.npz), each leaf under ``leaf_<i>:<path>``
    (viabel_tpu/checkpoint.py:91-113)."""
    arrays = {'leaf_{}:{}'.format(i, '/'.join(p)): _host(x)
              for i, (p, x) in enumerate(_flatten(tree))}
    d = os.path.dirname(os.path.abspath(path)) or '.'
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix='.npz.tmp')
    os.close(fd)
    try:
        with open(tmp, 'wb') as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _ordered_leaves(data):
    names = sorted((k for k in data.files if k.startswith('leaf_')),
                   key=lambda k: int(k.split(':')[0][5:]))
    return [data[k] for k in names]


def load_checkpoint(path, like=None):
    """Load a checkpoint: the flat list of its arrays, or, given `like` (a
    dict, list or tuple of the same structure), its arrays reassembled into
    that structure."""
    with np.load(path) as data:
        leaves = _ordered_leaves(data)
    if like is None:
        return leaves
    n = len(_flatten(like))
    if n != len(leaves):
        raise ValueError('the checkpoint has {} leaves and the structure '
                         '{}'.format(len(leaves), n))
    return _unflatten(like, iter(leaves))


def load_checkpoint_entry(path, name):
    """Load a single named entry (e.g. ``'param'``) from a checkpoint."""
    with np.load(path) as data:
        matches = [k for k in data.files
                   if k.startswith('leaf_') and
                   k.split(':', 1)[1].split('/')[-1] == name]
        if not matches:
            raise KeyError('no checkpoint entry named {!r}; available: {}'
                           .format(name,
                                   sorted(k.split(':', 1)[1]
                                          for k in data.files
                                          if ':' in k)))
        return data[matches[0]]


def _generator_state(generator):
    """The generator's state as a host ``uint8`` array, the checkpoint's
    key entry."""
    return generator.get_state().numpy()


def _entries_equal(a, b):
    """Value equality for checkpoint scalars: NaN equals NaN for floats (a
    ``learning_rate_end`` of None is stored as NaN), strings compare as
    strings."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == 'U' or b.dtype.kind == 'U':
        return str(a) == str(b)
    if a.dtype.kind == 'f' and b.dtype.kind == 'f':
        return np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


def _fmt_entry(v):
    """A checkpoint scalar for an error message: 0-d arrays as their
    value."""
    v = np.asarray(v)
    return str(v) if v.ndim == 0 else repr(v)


def _validate_resume(state, template, path, key_entry, value_entries=()):
    """Refuse a checkpoint that does not match the resuming run
    (viabel_tpu/checkpoint.py:176-218): another run configuration (entry
    shapes), another generator (the key entry, byte for byte; its length
    depends on the generator's device, so it is compared, not
    shape-checked) or other hyperparameters (`value_entries`)."""
    for name, ref in template.items():
        if name != key_entry and np.shape(state[name]) != np.shape(ref):
            raise ValueError(
                'cannot resume from {!r}: entry {!r} has shape {}, but this '
                'run expects {} — n_iters, window, and parameter sizes must '
                'match the run that wrote the checkpoint'.format(
                    path, name, np.shape(state[name]), np.shape(ref)))
    if not np.array_equal(np.asarray(state[key_entry]),
                          np.asarray(template[key_entry])):
        raise ValueError(
            'cannot resume from {!r}: it was written under a different PRNG '
            'key; resuming would silently switch the RNG stream mid-run — '
            'pass the key of the original run'.format(path))
    for name in value_entries:
        if not _entries_equal(state[name], template[name]):
            raise ValueError(
                'cannot resume from {!r}: it was written with {} = {}, but '
                'this run passes {} — resuming under different optimizer '
                'hyperparameters would silently corrupt the trajectory; '
                'pass the original value (or delete the checkpoint to '
                'restart)'.format(path, name, _fmt_entry(state[name]),
                                  _fmt_entry(template[name])))


def _stored_entry_names(path):
    """Leaf entry names recorded in a checkpoint file."""
    with np.load(path) as data:
        return {k.split(':', 1)[1].split('/')[-1]
                for k in data.files if ':' in k}


def _load_resume_state(checkpoint_path, template):
    """`load_checkpoint(like=template)` with a resume-specific error for a
    checkpoint of another structure, naming the ``return_history`` mode
    when that is the difference (viabel_tpu/checkpoint.py:228-268)."""
    stored = _stored_entry_names(checkpoint_path)
    expected = set(template)
    if stored != expected:
        mode_pairs = ({'params'}, {'tail_sum'})
        if (stored - expected, expected - stored) in (mode_pairs,
                                                      mode_pairs[::-1]):
            raise ValueError(
                'cannot resume from {!r}: it was written with '
                'return_history={} but this run passes return_history={} '
                '— resume in the mode that wrote the checkpoint (the two '
                'modes store different state: an iterate history vs a '
                'running tail sum)'.format(
                    checkpoint_path, 'True' if 'params' in stored
                    else 'False', 'params' in expected))
        raise ValueError(
            'cannot resume from {!r}: checkpoint entries {} do not match '
            'this run\'s {}. Note: checkpoints written by older versions '
            "of this library lack newer format entries (the 'key'/'keys' "
            'PRNG entry, pre-round-2; the hyperparameter scalars, '
            "pre-round-4; the 'format' id, pre-round-5) and cannot be "
            'resumed — delete the checkpoint or restart the run'.format(
                checkpoint_path, sorted(stored), sorted(expected)))
    return load_checkpoint(checkpoint_path, like=template)


def adagrad_optimize_resumable(n_iters, objective_and_grad, init_param, *,
                               checkpoint_path, generator=None,
                               save_every=1000, has_log_norm=None, window=10,
                               learning_rate=.01, epsilon=.1,
                               learning_rate_end=None, return_history=True,
                               device=None, draws=None):
    """Windowed adagrad with a checkpoint every `save_every` iterations and
    automatic resume (viabel_tpu/checkpoint.py:276-392).

    Each segment is `save_every` iterations of the body that
    `adagrad_optimize` runs (on the card a presampled objective's segment
    is replays of the captured body; a run resumed past the adagrad window
    captures at once), on the run's device-side state restored from the
    host (`ops.adagrad.restore_state`) and read back after it
    (`ops.adagrad.host_state`).  The draws are the whole run's: a
    presampled objective's block is drawn once from `generator` (or given
    as `draws`) and each segment reads its rows by the device counter; an
    objective that samples inside its step draws iteration i from
    ``fold_in(seed, i)``.  A resume draws again from `generator` and
    continues from the stored iteration, so a resumed run equals the
    uninterrupted one and `adagrad_optimize` on the same draws.

    If `checkpoint_path` exists the run resumes from it, after refusing a
    checkpoint of other shapes, of another generator state at the start of
    the call (the ``key`` entry) or of other hyperparameters.
    ``return_history=False`` stores a running tail sum instead of the
    ``(n_iters, P)`` history (a checkpoint of ``O(window P + n_iters)``),
    and returns None for the history; a run must resume in the mode that
    wrote its checkpoint.  Returns ``adagrad_optimize``'s 4-tuple, as
    tensors on `device`; the smoothed parameter is the mean of the tail of
    the history, or with ``return_history=False`` the tail sum divided as
    `adagrad_optimize` divides it.
    """
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = torch.as_tensor(init_param, device=device)
    P, dtype = init_param.shape[0], init_param.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    template = dict(
        i=np.zeros((), np.int64),
        key=_generator_state(generator),
        param=np.zeros(P, np_dtype),
        grads=np.zeros((window, P), np_dtype),
        log_norms=np.zeros(window, np_dtype),
        values=np.zeros(n_iters, np_dtype),
        lns=np.zeros(n_iters, np_dtype),
        learning_rate=np.asarray(float(learning_rate)),
        epsilon=np.asarray(float(epsilon)),
        learning_rate_end=np.asarray(
            np.nan if learning_rate_end is None else float(
                learning_rate_end)),
        format=np.asarray(FORMAT_ADAGRAD_HISTORY if return_history
                          else FORMAT_ADAGRAD_TAIL),
    )
    if return_history:
        template['params'] = np.zeros((n_iters, P), np_dtype)
    else:
        template['tail_sum'] = np.zeros(P, np_dtype)
    if os.path.exists(checkpoint_path):
        state = _load_resume_state(checkpoint_path, template)
        _validate_resume(state, template, checkpoint_path, 'key',
                         value_entries=('format', 'learning_rate',
                                        'epsilon', 'learning_rate_end'))
    else:
        state = template
        state['param'] = init_param.cpu().numpy()

    source = _source(_run_draws(objective_and_grad, obj, generator, n_iters,
                                dtype, draws), device)
    run = restore_state(
        state['param'], _learning_rates(n_iters, learning_rate,
                                        learning_rate_end, dtype).to(device),
        window, epsilon, return_history, int(state['i']), state['grads'],
        state['log_norms'], state.get('tail_sum', np.zeros(P, np_dtype)))
    i = int(state['i'])
    while i < n_iters:
        length = min(save_every, n_iters - i)
        _advance(obj, run, source, i, length, window)
        state['values'][i:i + length] = run.values[i:i + length].cpu().numpy()
        state['lns'][i:i + length] = run.log_norms[i:i + length].cpu().numpy()
        if return_history:
            state['params'][i:i + length] = \
                run.params[i:i + length].cpu().numpy()
        host = host_state(run)
        i = host['i']
        state.update(i=np.asarray(i), param=host['param'],
                     grads=host['grads'], log_norms=host['log_norms'])
        if not return_history:
            state['tail_sum'] = host['tail_sum']
        save_checkpoint(checkpoint_path, state)

    values = torch.as_tensor(state['values']).to(device)
    lns = torch.as_tensor(state['lns']).to(device)
    if not return_history:
        return run.tail_sum / (n_iters - run.tail_start), None, values, lns
    tail = state['params'][run.tail_start:]
    return (torch.as_tensor(tail.mean(axis=0)).to(device),
            torch.as_tensor(tail).to(device), values, lns)
