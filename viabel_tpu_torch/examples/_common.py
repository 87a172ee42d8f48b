"""What the examples share: their generators, seeded as the JAX examples
seed their keys (`_device.default_generator(device, seed)` for
``PRNGKey(seed)``), the end of a timed region, and the command line's
``--device``."""
import argparse

import torch

from .._device import default_generator, resolve_device
from ..experiments import _split
from ..ops.philox import fold_in

__all__ = ['default_generator', 'folded', 'split', 'synchronize', 'parser',
           'resolve_device']

split = _split  # the counterpart of jax.random.split(key, k)


def folded(gen, i):
    """The counterpart of ``jax.random.fold_in(key, i)``: a new generator
    on `gen`'s device seeded with ``ops.philox.fold_in`` of `gen`'s seed
    and `i`.  `gen` is not advanced."""
    return default_generator(gen.device, fold_in(gen.initial_seed(), i))


def synchronize(device):
    """Wait for `device`'s work (nothing on the CPU): the end of a timed
    region."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def parser(description, full=True):
    """An argument parser with ``--device`` (default: the CUDA card) and,
    unless told otherwise, ``--full``."""
    p = argparse.ArgumentParser(description=description)
    if full:
        p.add_argument('--full', action='store_true',
                       help="the reference's full configuration")
    p.add_argument('--device', default=None,
                   help='cuda (the default) or cpu')
    return p
