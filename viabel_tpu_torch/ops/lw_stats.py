"""Log-weight kernels of the bound pass, with their plain PyTorch versions.

Three CUDA kernels from ``csrc/lw_stats.cu`` (see the note at its top):

* `transform_score_partials` (K1) replaces the TPU kernel
  ``fused_location_scale_lw_stats`` (viabel_tpu/ops/sample_score.py:333-385
  at commit 2e6dc2c^): from base draws z (n, d), d <= `MAX_DIM`, of a
  mean-field family it forms ``x = mean + exp(log_scale) z`` and
  ``lw = log p(x) - log q(x)`` with log q from the base density of z,
  writes lw, and writes one row of partial statistics per chunk of `CHUNK`
  samples.  log p is a model's CUDA device function, named by its
  ``Model.kernel`` tag (`KERNEL_MODELS`): ``'eight_schools_cp'`` and
  ``'eight_schools_ncp'`` (d = 10, J = 8), ``'funnel'`` (d = 2) or
  ``'regression'``; K2 (`ops.gaussian_lw`) scores with the same ones.
  Every TPU row model (viabel_tpu/ops/row_models.py at 2e6dc2c^) has its
  device function.
* `lw_partials` (K3) replaces ``streaming_lw_stats``
  (viabel_tpu/ops/sample_score.py:108-142 at 2e6dc2c^): the same partials
  over an existing lw vector.
* `combine_partials` replaces the ``_combine_tiles`` epilogue
  (viabel_tpu/ops/sample_score.py:67-91 at 2e6dc2c^): one block reduces the
  partials to the five `log_weight_stats` fields
  ``[log_rescale, mean_rescaled_alpha, std_rescaled_alpha, mean_lw,
  std_lw]`` (population std, as ``jnp.std``).

Bound on an H100: K3 moves bytes, and so does K1 on eight-schools (it
reads 40 B of z and writes 4 B of lw a sample in f32; its ~230 operations
a sample need about a quarter of that time at the card's float32 rate)
and on the funnel (12 B and ~50 operations a sample); on the regression
density K1 is bound by operations (~2 N d a sample).  Each
reads its input once with warp-contiguous addresses, keeps the chunk's
log-weights in registers between score and statistics, and writes lw plus
one 6-value row per 2048 samples.

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
import math

import torch

from ..distributions import _LOG_2PI, t_lognorm
from ..models.eight_schools import cp_log_density, ncp_log_density
from ..models.funnel import funnel_log_density
from ..models.regression import regression_log_density
from . import _build
from .limits import MAX_DIM, MAX_STAGED_BYTES, staged_bytes

__all__ = [
    'CHUNK', 'MAX_DIM', 'KERNEL_MODELS', 'launches', 'reset_launches',
    'transform_score_partials', 'lw_partials', 'combine_partials',
    'transform_score_partials_plain', 'lw_partials_plain',
    'combine_partials_plain', 'lw_stats', 'transform_score_stats',
    'check_kernel_model', 'model_log_density_plain',
]

CHUNK = 2048          # samples per partials row; equals CHUNK in the .cuh
NPART = 6
# the CUDA densities, by Model.kernel tag, in the order of the .cuh's
# ModelKind
KERNEL_MODELS = ('eight_schools_cp', 'regression', 'eight_schools_ncp',
                 'funnel')
_SCHOOLS = 8          # the CUDA eight-schools densities unroll J = 8
_FUNNEL_DIM = 2

launches = {'transform_score_partials': 0, 'lw_partials': 0,
            'combine_partials': 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


class ModelSpec(ctypes.Structure):
    """ctypes mirror of ``bound_pass::ModelSpec`` (csrc/bound_pass.cuh)."""
    _fields_ = [('kind', ctypes.c_int), ('n_rows', ctypes.c_int),
                ('student_t', ctypes.c_int), ('pad', ctypes.c_int),
                ('a', ctypes.c_void_p), ('b', ctypes.c_void_p),
                ('df', ctypes.c_double), ('half_df1', ctypes.c_double),
                ('lik_lognorm', ctypes.c_double),
                ('noise_scale', ctypes.c_double),
                ('log_noise', ctypes.c_double),
                ('prior_std', ctypes.c_double),
                ('log_prior', ctypes.c_double)]


_ptr = ctypes.c_void_p
_SIGNATURES = {
    'transform_score_partials': [_ptr] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ModelSpec), _ptr,
        _ptr],
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
    check_layout(lib, 'lw_stats')
    return lib


def check_layout(lib, name):
    """Raise unless the library built from ``csrc/<name>.cu`` agrees with
    this module on CHUNK, MAX_DIM and the ModelSpec layout."""
    fns = (lib.bound_pass_chunk, lib.bound_pass_max_dim,
           lib.bound_pass_model_spec_size)
    for fn in fns:
        fn.argtypes, fn.restype = [], ctypes.c_int
    got = tuple(fn() for fn in fns)
    if got != (CHUNK, MAX_DIM, ctypes.sizeof(ModelSpec)):
        raise RuntimeError('csrc/{}.cu and ops/lw_stats.py disagree on '
                           'CHUNK, MAX_DIM or the ModelSpec layout: {}'
                           .format(name, got))


def launch(lib, counts, name, device, dtype, *args):
    """Launch ``<name>_<f32|f64>`` of `lib` on `device`'s current stream,
    raise if CUDA refused it, and count it in ``counts[name]``."""
    fn = getattr(lib, '{}_{}'.format(name, _SUFFIX[dtype]))
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError('{} launch failed: CUDA error {}'.format(name, rc))
    counts[name] += 1


def _launch(name, device, dtype, *args):
    launch(_lib(), launches, name, device, dtype, *args)


def check_tensor(name, t, dtype, device, shape=None):
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


def n_chunks(n):
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


def model_log_density_plain(kernel, kernel_data, x):
    """The plain version of the CUDA log density named `kernel` at the rows
    of ``x`` (n, d)."""
    if kernel in ('eight_schools_cp', 'eight_schools_ncp'):
        y, sigma = (t.to(x.device, x.dtype) for t in kernel_data)
        density = (cp_log_density if kernel == 'eight_schools_cp'
                   else ncp_log_density)
        return density(x, y, sigma)
    if kernel == 'funnel':
        return funnel_log_density(x, *kernel_data)
    xd, y, df, noise_scale, prior_std = kernel_data
    return regression_log_density(x, xd.to(x.device, x.dtype),
                                  y.to(x.device, x.dtype), df, noise_scale,
                                  prior_std)


def check_kernel_model(kernel, kernel_data, d, itemsize):
    """Raise unless the CUDA density named `kernel` takes `kernel_data` at
    dimension `d`, and the score kernels can stage it in shared memory."""
    if kernel not in KERNEL_MODELS:
        raise ValueError('no kernel log density named {!r}'.format(kernel))
    if not 1 <= d <= MAX_DIM:
        raise ValueError('the score kernels take 1 <= d <= {}, got {}'
                         .format(MAX_DIM, d))
    if kernel in ('eight_schools_cp', 'eight_schools_ncp'):
        if (d != 2 + _SCHOOLS or [tuple(t.shape) for t in kernel_data]
                != [(_SCHOOLS,)] * 2):
            raise ValueError('{} needs d = {} and y and sigma of {} schools'
                             .format(kernel, 2 + _SCHOOLS, _SCHOOLS))
        staged = 2 * _SCHOOLS
    elif kernel == 'funnel':
        if d != _FUNNEL_DIM or len(kernel_data) != 1:
            raise ValueError('{} needs d = {} and (log_sigma_stdev,), got '
                             'd = {}'.format(kernel, _FUNNEL_DIM, d))
        staged = 0
    else:
        xd, y = kernel_data[:2]
        if xd.dim() != 2 or xd.shape[1] != d or tuple(y.shape) != (
                xd.shape[0],):
            raise ValueError('{} needs x (N, {}) and y (N,), got {} and {}'
                             .format(kernel, d, tuple(xd.shape),
                                     tuple(y.shape)))
        staged = xd.shape[0] * (d + 1)
    nbytes = staged_bytes(staged, itemsize)
    if nbytes > MAX_STAGED_BYTES:
        raise ValueError('{} data of {} bytes exceeds the {} bytes of shared '
                         'memory the score kernels stage'.format(
                             kernel, nbytes, MAX_STAGED_BYTES))


def model_spec(kernel, kernel_data, device, dtype):
    """The `ModelSpec` of a launch and the device tensors it points to
    (the caller holds them until the launch is enqueued)."""
    kind = KERNEL_MODELS.index(kernel)
    if kernel in ('eight_schools_cp', 'eight_schools_ncp'):
        a, b = (t.to(device, dtype).contiguous() for t in kernel_data)
        spec = ModelSpec(kind=kind, n_rows=a.shape[0], a=a.data_ptr(),
                         b=b.data_ptr())
        return spec, (a, b)
    if kernel == 'funnel':  # its prior scale rides in prior_std
        s, = kernel_data
        return ModelSpec(kind=kind, prior_std=s, log_prior=math.log(s)), ()
    xd, y, df, noise_scale, prior_std = kernel_data
    a, b = (t.to(device, dtype).contiguous() for t in (xd, y))
    spec = ModelSpec(
        kind=kind, n_rows=a.shape[0], student_t=int(df is not None),
        a=a.data_ptr(), b=b.data_ptr(), df=float(df or 0.0),
        half_df1=0.5 * (df + 1.0) if df is not None else 0.0,
        lik_lognorm=t_lognorm(df) if df is not None else 0.0,
        noise_scale=noise_scale, log_noise=math.log(noise_scale),
        prior_std=prior_std, log_prior=math.log(prior_std))
    return spec, (a, b)


def transform_score_partials_plain(z, mean, log_scale, kernel, kernel_data,
                                   df=None, alpha=2.0):
    """Plain version of K1: ``(lw, partials)``."""
    x = mean + torch.exp(log_scale) * z
    logq = _base_logpdf(z, df) - torch.sum(log_scale)
    lw = model_log_density_plain(kernel, kernel_data, x) - logq
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
    check_tensor('z', z, None, None)
    if z.dim() != 2 or z.shape[0] == 0:
        raise ValueError('z must be (n > 0, d), got {}'.format(
            tuple(z.shape)))
    n, d = z.shape
    check_kernel_model(kernel, kernel_data, d, z.element_size())
    check_tensor('mean', mean, z.dtype, z.device, (d,))
    check_tensor('log_scale', log_scale, z.dtype, z.device, (d,))
    if z.device.type == 'cpu':
        return transform_score_partials_plain(z, mean, log_scale, kernel,
                                              kernel_data, df, alpha)
    spec, _data = model_spec(kernel, kernel_data, z.device, z.dtype)
    lw = torch.empty((n,), dtype=z.dtype, device=z.device)
    partials = torch.empty((n_chunks(n), NPART), dtype=z.dtype,
                           device=z.device)
    base_kind = 0 if df is None else 1  # standard normal / Student-t(df)
    _launch('transform_score_partials', z.device, z.dtype, z.data_ptr(),
            mean.data_ptr(), log_scale.data_ptr(), n, d, base_kind,
            float(df or 0.0), t_lognorm(df) if df is not None else 0.0,
            float(alpha), ctypes.byref(spec), lw.data_ptr(),
            partials.data_ptr())
    return lw, partials


def lw_partials(lw, alpha=2.0):
    """K3: partials ``(ceil(n / CHUNK), 6)`` of a log-weight vector."""
    check_tensor('lw', lw, None, None)
    if lw.dim() != 1 or lw.shape[0] == 0:
        raise ValueError('lw must be 1-D and non-empty')
    if lw.device.type == 'cpu':
        return lw_partials_plain(lw, alpha)
    n = lw.shape[0]
    partials = torch.empty((n_chunks(n), NPART), dtype=lw.dtype,
                           device=lw.device)
    _launch('lw_partials', lw.device, lw.dtype, lw.data_ptr(), n,
            float(alpha), partials.data_ptr())
    return partials


def combine_partials(partials, alpha=2.0):
    """The five `log_weight_stats` fields, as a (5,) tensor, from partials."""
    check_tensor('partials', partials, None, None)
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
