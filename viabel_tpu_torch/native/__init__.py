"""Native (C++) compiled log-density providers.

PyTorch port of viabel_tpu/native/__init__.py: the eight-schools centred
log posterior and the robust-regression log posterior, each with its
analytic gradient, in C++ (this package's own copies,
``eight_schools.cpp`` and ``regression.cpp``), built with ``g++`` into a
shared library under ``viabel_tpu_torch/_build/native/`` at first use,
loaded over ctypes, and bridged into PyTorch through
`models.make_callback_log_density` in its batched form.  The library runs
at float64 on the host, one call for a whole batch; the result comes back
on the input's device in its dtype.

These densities are host-side (``host_callback``): the optimizers and
HMC run them eagerly, never in a CUDA graph, and the bound pass scores
them with the plain composition and the log-weight kernels (they have no
fused-kernel row model).  For the models the package already has in
torch, the torch model is faster on the card; the native path is for
densities that only external compiled code evaluates, the situation the
reference's Stan bridge serves.
"""
import ctypes
import hashlib
import math
import os
import platform
import subprocess
import threading

import numpy as np

__all__ = ['build_native_library', 'native_eight_schools_cp_log_density',
           'native_robust_regression_log_density']

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, f) for f in ('eight_schools.cpp',
                                          'regression.cpp')]
_BUILD = os.path.join(os.path.dirname(_HERE), '_build', 'native')
_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC')

_lock = threading.Lock()
_lib = None


def _target():
    """The library's path, keyed by the sources, the flags and the host:
    an edited source builds anew, an unchanged one loads the cached
    library, and a checkout shared between machines never loads code that
    ``-march=native`` compiled for another CPU."""
    digest = hashlib.sha256(' '.join(
        _FLAGS + (platform.node(), platform.machine())).encode())
    for path in _SRCS:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return os.path.join(_BUILD, 'libviabel_native-{}.so'.format(
        digest.hexdigest()[:16]))


def build_native_library(force=False):
    """Compile the native library with g++ (cached, with OpenMP where the
    toolchain takes it, viabel_tpu/native/__init__.py:30-47).  Returns the
    ``.so`` path under ``viabel_tpu_torch/_build/native/``, or raises
    RuntimeError if no toolchain is available."""
    target = _target()
    if os.path.exists(target) and not force:
        return target
    os.makedirs(_BUILD, exist_ok=True)
    # a file of this process's own, renamed into place: a concurrent
    # builder or reader sees the whole library or none
    tmp = '{}.{}.{}.tmp'.format(target, os.getpid(), threading.get_ident())
    base = ['g++', *_FLAGS, *_SRCS, '-o', tmp]
    try:  # OpenMP batch parallelism when the toolchain supports it
        subprocess.run(base + ['-fopenmp'], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        try:
            subprocess.run(base, check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            raise RuntimeError('failed to build native library: {}'
                               .format(e))
    os.replace(tmp, target)
    return target


def _load():
    """The library with its ctypes signatures
    (viabel_tpu/native/__init__.py:50-64), built and loaded once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_native_library())
        dp = ctypes.POINTER(ctypes.c_double)
        i64, f64 = ctypes.c_int64, ctypes.c_double
        for name in ('es_cp_log_prob', 'es_cp_grad_log_prob'):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [dp, i64, i64, dp, dp, dp]
        lib.robust_reg_log_prob.restype = None
        lib.robust_reg_log_prob.argtypes = [dp, i64, i64, i64, dp, dp, f64,
                                            f64, f64, f64, dp]
        lib.robust_reg_grad_log_prob.restype = None
        lib.robust_reg_grad_log_prob.argtypes = [dp, i64, i64, i64, dp, dp,
                                                 f64, f64, f64, dp]
        _lib = lib
        return lib


def _rows(x, dim):
    """A batch as the C-contiguous float64 ``(n, dim)`` array the library
    reads."""
    return np.ascontiguousarray(x, dtype=np.float64).reshape(-1, dim)


def native_eight_schools_cp_log_density(y=None, sigma=None):
    """The eight-schools CP log density backed by the C++ library, a
    differentiable host-side density (the `make_stan_log_density`
    counterpart with a real native evaluator; reference:
    viabel/vb.py:314-321; viabel_tpu/native/__init__.py:67-98)."""
    from ..models import (EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y,
                          make_callback_log_density)
    y = np.ascontiguousarray(EIGHT_SCHOOLS_Y if y is None else y,
                             dtype=np.float64)
    sigma = np.ascontiguousarray(EIGHT_SCHOOLS_SIGMA if sigma is None
                                 else sigma, dtype=np.float64)
    J = len(y)
    dim = 2 + J
    lib = _load()
    dp = ctypes.POINTER(ctypes.c_double)
    y_p = y.ctypes.data_as(dp)
    s_p = sigma.ctypes.data_as(dp)

    def log_prob(x):
        x = _rows(x, dim)
        out = np.empty(x.shape[0], dtype=np.float64)
        lib.es_cp_log_prob(x.ctypes.data_as(dp), x.shape[0], J, y_p, s_p,
                           out.ctypes.data_as(dp))
        return out

    def grad_log_prob(x):
        x = _rows(x, dim)
        out = np.empty_like(x)
        lib.es_cp_grad_log_prob(x.ctypes.data_as(dp), x.shape[0], J, y_p,
                                s_p, out.ctypes.data_as(dp))
        return out

    return make_callback_log_density(log_prob, grad_log_prob, dim,
                                     batched=True)


def native_robust_regression_log_density(x=None, y=None, df=40.0,
                                         noise_scale=1.0, prior_std=10.0):
    """The robust-regression log density backed by the C++ library
    (reference: notebooks/robust-regression.ipynb cell 3 Stan program via
    viabel/vb.py:314-321; viabel_tpu/native/__init__.py:101-147).
    Defaults to the notebook's seed-5039 data; `x` and `y` come together
    or not at all."""
    from ..models import make_callback_log_density
    from ..models.regression import robust_regression_notebook_data
    if (x is None) != (y is None):
        raise ValueError('pass both x and y, or neither (notebook data)')
    if x is None:
        x, y = robust_regression_notebook_data()
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64).reshape(-1)
    N, D = x.shape
    if y.shape != (N,):
        raise ValueError('y must have one response per row of x '
                         '(got {} responses for {} rows)'.format(
                             y.shape[0], N))
    lognorm = (math.lgamma(0.5 * (df + 1.0)) - math.lgamma(0.5 * df)
               - 0.5 * math.log(df * math.pi))
    lib = _load()
    dp = ctypes.POINTER(ctypes.c_double)
    x_p = x.ctypes.data_as(dp)
    y_p = y.ctypes.data_as(dp)

    def log_prob(b):
        b = _rows(b, D)
        out = np.empty(b.shape[0], dtype=np.float64)
        lib.robust_reg_log_prob(b.ctypes.data_as(dp), b.shape[0], N, D,
                                x_p, y_p, df, noise_scale, prior_std,
                                lognorm, out.ctypes.data_as(dp))
        return out

    def grad_log_prob(b):
        b = _rows(b, D)
        out = np.empty_like(b)
        lib.robust_reg_grad_log_prob(b.ctypes.data_as(dp), b.shape[0], N,
                                     D, x_p, y_p, df, noise_scale,
                                     prior_std, out.ctypes.data_as(dp))
        return out

    return make_callback_log_density(log_prob, grad_log_prob, D,
                                     batched=True)
