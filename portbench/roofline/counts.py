"""Operations and bytes that the program's kernels and calls need, from
their shapes: each input byte read once and each output byte written
once; a product of an (m, k) by a (k, n) matrix 2 m k n operations.

`adagrad_step_bytes` and `k1_bytes` are the byte counts of the port's
kernel table (PERF.md), frozen here.
"""


def param_count(cfg):
    """The variational parameters of the configuration's family."""
    d = cfg['dim']
    return d * (d + 3) // 2 if cfg['family'].startswith('full_rank') \
        else 2 * d


def adagrad_step_bytes(K, P, window, history=False, itemsize=4):
    """The windowed-adagrad step kernel for K runs of P parameters: the
    gradient, the ring (window rows and log-norms), the parameter, the
    tail sum, the learning rate, value, log-norm and the counter read;
    the parameter, the ring's new row and log-norm, the tail sum, value,
    log-norm and the counter written, and the history row where the run
    keeps its history (a validated fit does not)."""
    read = itemsize * (P * (window + 3) + window + 3) + 8
    written = itemsize * ((3 + bool(history)) * P + 3) + 8
    return K * (read + written)


def k1_bytes(n, d, staged, itemsize=4):
    """K1 (`transform_score_partials`): n base draws of d coordinates in,
    the log-weights and one row of 6 partial statistics per 2048 samples
    out, the location, log-scales and the model's `staged` data in."""
    return (n * d * itemsize + n * itemsize + -(-n // 2048) * 6 * itemsize
            + itemsize * (2 * d + staged))


def full_rank_regression_fit_flops(N, d, n_mc, n_iters, n_bound):
    """The products of a validated KLVI fit of a full-rank Gaussian q to
    a linear regression of N rows: each iteration the transform
    ``theta = mu + L z`` of n_mc draws (L triangular: d (d + 1) / 2
    multiply-adds a draw), ``X theta`` and its gradient (N d each), and
    the gradient of the transform in L; then the bound pass's transform
    and scoring (``X theta`` and the triangular solve of log q) over
    n_bound samples."""
    tri = d * (d + 1)                     # 2 * d (d + 1) / 2
    per_iter = n_mc * (2 * tri + 4 * N * d)
    return n_iters * per_iter + n_bound * (2 * tri + 2 * N * d)


def validation_pass_flops(n, d):
    """The products of a validation pass of a mean-field q: the
    transform (a multiply-add a coordinate), and the PSIS-weighted mean
    and covariance (n d and n d^2 multiply-adds)."""
    return 2 * n * d + 2 * n * d + 2 * n * d * d
