"""What the fused score kernels K1 and K2 (``csrc/bound_pass.cuh``) can
take: the largest dimension, and the shared memory in which each block
stages the variational mean and scale and the model's data.

`ops.lw_stats` checks every launch against these; a regression model
carries its kernel tag only where its data fits (`models.regression`).
"""

__all__ = ['MAX_DIM', 'MAX_STAGED_BYTES', 'staged_bytes', 'fits']

MAX_DIM = 32                   # equals MAX_DIM in the .cuh
MAX_STAGED_BYTES = 96 * 1024


def staged_bytes(n_values, itemsize):
    """Shared memory a score kernel stages: mean and scale (`MAX_DIM`
    values each), then `n_values` values of the model's data."""
    return (2 * MAX_DIM + n_values) * itemsize


def fits(d, n_values, itemsize):
    """Whether the score kernels take dimension `d` with `n_values` values
    of model data of `itemsize` bytes each."""
    return (1 <= d <= MAX_DIM
            and staged_bytes(n_values, itemsize) <= MAX_STAGED_BYTES)
