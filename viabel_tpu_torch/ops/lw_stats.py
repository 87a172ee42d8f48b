"""Log-weight kernels of the bound pass, with their plain PyTorch versions.

Three CUDA kernels from ``csrc/lw_stats.cu`` (see the note at its top):

* `transform_score_partials` (K1) replaces the TPU kernel
  ``fused_location_scale_lw_stats`` (viabel_tpu/ops/sample_score.py:333-385
  at commit 2e6dc2c^): from base draws z (n, d) of a mean-field family it
  forms ``x = mean + exp(log_scale) z`` and ``lw = log p(x) - log q(x)``
  with log q from the base density of z, writes lw, and writes one row of
  partial statistics per chunk of `CHUNK` samples.
* `lw_partials` (K3) replaces ``streaming_lw_stats``
  (viabel_tpu/ops/sample_score.py:108-142 at 2e6dc2c^): the same partials
  over an existing lw vector.
* `combine_partials` replaces the ``_combine_tiles`` epilogue
  (viabel_tpu/ops/sample_score.py:67-91 at 2e6dc2c^): one block reduces the
  partials to the five `log_weight_stats` fields
  ``[log_rescale, mean_rescaled_alpha, std_rescaled_alpha, mean_lw,
  std_lw]`` (population std, as ``jnp.std``).

Bound on an H100: K1 and K3 move bytes (K1 reads 40 B of z and writes 4 B
of lw a sample in f32; its ~230 operations a sample need about a quarter
of that time at the card's float32 rate).  Each reads its input once with warp-contiguous
addresses, keeps the chunk's log-weights in registers between score and
statistics, and writes lw plus one 6-value row per 2048 samples.

Partials row: ``[count, m, mean_e, M2_e, mean_lw, M2_lw]`` with m the
chunk max, ``e = exp(lw - m)^alpha`` and M2 the sum of squared
deviations.  The combine rescales chunk b by ``r_b = exp(m_b - M)^alpha``
(mean by r_b, M2 by r_b^2) and merges by Chan's rule.  The JAX package's
retired combine formed variances as ``s2/n - mean^2``, which cancels in
f32; neither version here ever forms a raw second moment.

Each wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (building it on first use) or raises.
`launches` counts kernel launches, one per wrapper call that launched.
"""
import ctypes
import functools

import torch

from ..distributions import _LOG_2PI, t_lognorm
from ..models.eight_schools import cp_log_density
from . import _build

__all__ = [
    'CHUNK', 'launches', 'reset_launches',
    'transform_score_partials', 'lw_partials', 'combine_partials',
    'transform_score_partials_plain', 'lw_partials_plain',
    'combine_partials_plain', 'lw_stats', 'transform_score_stats',
]

CHUNK = 2048          # samples per partials row; equals CHUNK in the .cu
NPART = 6
DIM = 10              # the CUDA model density is eight-schools CP, J = 8
_PLAIN_DENSITIES = {'eight_schools_cp': cp_log_density}

launches = {'transform_score_partials': 0, 'lw_partials': 0,
            'combine_partials': 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


_ptr = ctypes.c_void_p
_SIGNATURES = {
    'transform_score_partials': [_ptr] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _ptr, _ptr, _ptr],
    'lw_partials': [_ptr, ctypes.c_longlong, ctypes.c_double, _ptr, _ptr],
    'combine_partials': [_ptr, ctypes.c_longlong, ctypes.c_double, _ptr,
                         _ptr],
}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with every entry point's C signature declared."""
    lib = _build.load('lw_stats')
    for name, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, '{}_{}'.format(name, suffix))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for fn in (lib.lw_stats_chunk, lib.lw_stats_dim):
        fn.argtypes, fn.restype = [], ctypes.c_int
    if (lib.lw_stats_chunk(), lib.lw_stats_dim()) != (CHUNK, DIM):
        raise RuntimeError('csrc/lw_stats.cu and ops/lw_stats.py disagree '
                           'on CHUNK or DIM')
    return lib


def _launch(name, device, dtype, *args):
    """Launch on `device`'s current stream; raise if CUDA refused it."""
    fn = getattr(_lib(), '{}_{}'.format(name, _SUFFIX[dtype]))
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError('{} launch failed: CUDA error {}'.format(name, rc))
    launches[name] += 1


def _check(name, t, dtype, device, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError('{} must be a tensor'.format(name))
    if t.dtype not in _SUFFIX or (dtype is not None and t.dtype != dtype):
        raise TypeError('{} must be float32 or float64 (and match the other '
                        'inputs), got {}'.format(name, t.dtype))
    if device is not None and t.device != device:
        raise ValueError('{} is on {}, expected {}'.format(
            name, t.device, device))
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError('{} is on {}: only cpu and cuda are supported'
                         .format(name, t.device))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError('{} has shape {}, expected {}'.format(
            name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('{} must be contiguous'.format(name))


def _n_chunks(n):
    return -(-n // CHUNK)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _rows_partials(rows, alpha):
    """Partials of each row of ``rows`` (b, count)."""
    count = torch.full((rows.shape[0],), rows.shape[1], dtype=rows.dtype,
                       device=rows.device)
    m = torch.max(rows, dim=1).values
    e = torch.exp(rows - m[:, None]) ** alpha
    mean_e = torch.mean(e, dim=1)
    mean_lw = torch.mean(rows, dim=1)
    m2_e = torch.sum((e - mean_e[:, None]) ** 2, dim=1)
    m2_lw = torch.sum((rows - mean_lw[:, None]) ** 2, dim=1)
    return torch.stack([count, m, mean_e, m2_e, mean_lw, m2_lw], dim=1)


def lw_partials_plain(lw, alpha=2.0):
    """Plain version of K3: one partials row per `CHUNK` samples, the last
    row over the ragged remainder."""
    n = lw.shape[0]
    n_full = n // CHUNK
    parts = []
    if n_full:
        parts.append(_rows_partials(lw[:n_full * CHUNK].reshape(n_full, CHUNK),
                                    alpha))
    if n % CHUNK:
        parts.append(_rows_partials(lw[n_full * CHUNK:].reshape(1, -1), alpha))
    return torch.cat(parts)


def _chan(a, b):
    """Chan's rule on groups ``(count, mean, M2)``, counts in float64."""
    na, mean_a, m2_a = a
    nb, mean_b, m2_b = b
    n = na + nb
    delta = mean_b - mean_a
    mean = mean_a + delta * (nb / n).to(mean_a.dtype)
    m2 = m2_a + m2_b + delta * delta * (na * nb / n).to(mean_a.dtype)
    return n, mean, m2


def combine_partials_plain(partials, alpha=2.0):
    """Plain version of the combine: rescale to the global max, then a tree
    of Chan merges (pairs at each level, as the kernel's block does)."""
    count, m, mean_e, m2_e, mean_lw, m2_lw = partials.unbind(1)
    big_m = torch.max(m)
    r = torch.exp(m - big_m) ** alpha
    count = count.to(torch.float64)
    e = (count, mean_e * r, m2_e * r * r)
    lw = (count, mean_lw, m2_lw)
    while e[0].shape[0] > 1:
        if e[0].shape[0] % 2:  # pad with an empty group
            e = tuple(torch.cat([t, t.new_zeros(1)]) for t in e)
            lw = tuple(torch.cat([t, t.new_zeros(1)]) for t in lw)
        # merging an empty group (count 0) leaves the other unchanged
        e = _chan(tuple(t[0::2] for t in e), tuple(t[1::2] for t in e))
        lw = _chan(tuple(t[0::2] for t in lw), tuple(t[1::2] for t in lw))
    n = e[0][0].to(partials.dtype)
    return torch.stack([big_m, e[1][0], torch.sqrt(e[2][0] / n), lw[1][0],
                        torch.sqrt(lw[2][0] / n)])


def _base_logpdf(z, df):
    """Standard normal (df None) or Student-t(df) log density of the rows
    of z, summed over the last axis."""
    if df is None:
        return -0.5 * torch.sum(z * z + _LOG_2PI, dim=-1)
    return torch.sum(
        t_lognorm(df) - 0.5 * (df + 1.0) * torch.log1p(z * z / df), dim=-1)


def transform_score_partials_plain(z, mean, log_scale, kernel, kernel_data,
                                   df=None, alpha=2.0):
    """Plain version of K1: ``(lw, partials)``."""
    x = mean + torch.exp(log_scale) * z
    logq = _base_logpdf(z, df) - torch.sum(log_scale)
    y, sigma = (t.to(z.device, z.dtype) for t in kernel_data)
    lw = _PLAIN_DENSITIES[kernel](x, y, sigma) - logq
    return lw, lw_partials_plain(lw, alpha)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def transform_score_partials(z, mean, log_scale, kernel, kernel_data,
                             df=None, alpha=2.0):
    """K1: ``(lw (n,), partials (ceil(n / CHUNK), 6))`` for base draws
    ``z`` (n, d) of a mean-field family at ``[mean, log_scale]``, scored by
    the model density named `kernel` (its data `kernel_data`).  ``df`` None
    means a standard normal base (the Gaussian family), else Student-t(df).
    """
    if kernel not in _PLAIN_DENSITIES:
        raise ValueError('no kernel log density named {!r}'.format(kernel))
    _check('z', z, None, None)
    if z.dim() != 2 or z.shape[0] == 0 or z.shape[1] != DIM:
        raise ValueError('z must be (n > 0, {}), got {}'.format(
            DIM, tuple(z.shape)))
    n = z.shape[0]
    _check('mean', mean, z.dtype, z.device, (DIM,))
    _check('log_scale', log_scale, z.dtype, z.device, (DIM,))
    if [tuple(t.shape) for t in kernel_data] != [(DIM - 2,)] * 2:
        raise ValueError('{} needs y and sigma of {} schools'.format(
            kernel, DIM - 2))
    if z.device.type == 'cpu':
        return transform_score_partials_plain(z, mean, log_scale, kernel,
                                              kernel_data, df, alpha)
    y, sigma = (t.to(z.device, z.dtype).contiguous() for t in kernel_data)
    lw = torch.empty((n,), dtype=z.dtype, device=z.device)
    partials = torch.empty((_n_chunks(n), NPART), dtype=z.dtype,
                           device=z.device)
    base_kind = 0 if df is None else 1  # standard normal / Student-t(df)
    _launch('transform_score_partials', z.device, z.dtype, z.data_ptr(),
            mean.data_ptr(), log_scale.data_ptr(), y.data_ptr(),
            sigma.data_ptr(), n, base_kind, float(df or 0.0),
            t_lognorm(df) if df is not None else 0.0, float(alpha),
            lw.data_ptr(), partials.data_ptr())
    return lw, partials


def lw_partials(lw, alpha=2.0):
    """K3: partials ``(ceil(n / CHUNK), 6)`` of a log-weight vector."""
    _check('lw', lw, None, None)
    if lw.dim() != 1 or lw.shape[0] == 0:
        raise ValueError('lw must be 1-D and non-empty')
    if lw.device.type == 'cpu':
        return lw_partials_plain(lw, alpha)
    n = lw.shape[0]
    partials = torch.empty((_n_chunks(n), NPART), dtype=lw.dtype,
                           device=lw.device)
    _launch('lw_partials', lw.device, lw.dtype, lw.data_ptr(), n,
            float(alpha), partials.data_ptr())
    return partials


def combine_partials(partials, alpha=2.0):
    """The five `log_weight_stats` fields, as a (5,) tensor, from partials."""
    _check('partials', partials, None, None)
    if partials.dim() != 2 or partials.shape[1] != NPART \
            or partials.shape[0] == 0:
        raise ValueError('partials must be (b > 0, {})'.format(NPART))
    if partials.device.type == 'cpu':
        return combine_partials_plain(partials, alpha)
    out = torch.empty((5,), dtype=partials.dtype, device=partials.device)
    _launch('combine_partials', partials.device, partials.dtype,
            partials.data_ptr(), partials.shape[0], float(alpha),
            out.data_ptr())
    return out


def lw_stats(lw, alpha=2.0):
    """K3 then the combine: the (5,) statistics tensor of ``lw``."""
    return combine_partials(lw_partials(lw, alpha), alpha)


def transform_score_stats(z, mean, log_scale, kernel, kernel_data, df=None,
                          alpha=2.0):
    """K1 then the combine: ``(lw, stats (5,))``."""
    lw, partials = transform_score_partials(z, mean, log_scale, kernel,
                                            kernel_data, df, alpha)
    return lw, combine_partials(partials, alpha)
