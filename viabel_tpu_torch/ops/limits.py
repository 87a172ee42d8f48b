"""What the fused score kernels K1 and K2 (``csrc/bound_pass.cuh``) can
take: the largest dimension, and the shared memory in which each block
stages the variational mean and scale and the model's data.

`ops.lw_stats` checks every launch against these; a regression model
carries its kernel tag only where its data fits (`models.regression`).
"""

__all__ = ['MAX_DIM', 'MAX_STAGED_BYTES', 'staged_bytes', 'fits',
           'regression_row']

MAX_DIM = 32                   # equals MAX_DIM in the .cuh
MAX_STAGED_BYTES = 96 * 1024   # equals MAX_STAGED_BYTES in the .cuh


def regression_row(d, itemsize):
    """Values of one regression row as the score kernels stage it: x_k,
    y_k, then zeros to a whole number of 16-byte words (``regression_row``
    in the .cuh)."""
    word = 16 // itemsize
    return -(-(d + 1) // word) * word


def staged_bytes(n_values, itemsize):
    """Shared memory a score kernel stages: mean and scale (`MAX_DIM`
    values each), then `n_values` values of the model's data."""
    return (2 * MAX_DIM + n_values) * itemsize


def fits(d, n_values, itemsize):
    """Whether the score kernels take dimension `d` with `n_values` values
    of model data of `itemsize` bytes each."""
    return (1 <= d <= MAX_DIM
            and staged_bytes(n_values, itemsize) <= MAX_STAGED_BYTES)
