"""The mean-field-Gaussian bound pass with in-kernel draws, and the Philox
normal stream, with their plain PyTorch versions.

Two CUDA kernels from ``csrc/gaussian_lw.cu`` (see the note at its top):

* `gaussian_sample_score_partials` (K2) replaces the TPU kernel
  ``fused_gaussian_lw_stats`` (viabel_tpu/ops/sample_score.py:223-282 at
  commit 2e6dc2c^): it draws each sample's d standard normals from the
  Philox stream of ``(seed, offset)`` in registers, forms
  ``x = mean + exp(log_std) z``, scores ``lw = log p(x) - log q(x)`` with
  the closed-form Gaussian log q and the model's CUDA density
  (`lw_stats.KERNEL_MODELS`), writes lw and one partials row per
  `lw_stats.CHUNK` samples, which `lw_stats.combine_partials` reduces.  It
  never writes samples.
* `philox_normal` writes the same z (n, d) of the same stream, for the
  callers that need the samples (PSIS and `get_samples_and_log_weights`).
  Each block computes a tile of consecutive samples into shared memory
  and stores the tile's contiguous run in 16-byte words; the last group of
  a row computes only the Box-Muller pair the row keeps.

The stream is `ops.philox`'s: the plain versions draw the same uniforms
bit for bit, so a CPU run and a card run of one ``(seed, offset)`` score
the same samples.  Each wrapper takes the plain version only for a tensor
on the CPU; on CUDA it launches the kernel or raises (`ops._launch`, which
counts the launches).  `philox_bits` runs the bare generator on given
counters, for the checks on the card; it is on no path and is not counted.
"""
import ctypes

import torch

from . import lw_stats as _lw
from ._launch import Library
from .philox import _check_stream, philox_normal_plain

__all__ = [
    'gaussian_sample_score_partials', 'gaussian_sample_score_partials_plain',
    'philox_normal', 'philox_bits',
]

_ptr = ctypes.c_void_p
_u64, _u32 = ctypes.c_ulonglong, ctypes.c_uint
_SIGNATURES = {
    'gaussian_sample_score_partials': [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _u64, _u32, _u64,
        ctypes.c_double, ctypes.POINTER(_lw.ModelSpec), _ptr, _ptr],
    'philox_normal': [ctypes.c_longlong, ctypes.c_int, _u64, _u64, _u32,
                      _ptr],
}
_LIB = Library('gaussian_lw', _SIGNATURES, check=_lw.check_layout,
               helpers={'philox_bits': [_ptr, ctypes.c_longlong, _u64, _ptr,
                                        _ptr]})


def gaussian_sample_score_partials_plain(mean, log_std, n, seed, offset,
                                         kernel, kernel_data, alpha=2.0,
                                         start=0):
    """Plain version of K2: the plain Philox z, then K1's plain version
    with a standard normal base."""
    z = philox_normal_plain(n, mean.shape[0], seed, offset, start,
                            mean.dtype, mean.device)
    return _lw.transform_score_partials_plain(z, mean, log_std, kernel,
                                              kernel_data, None, alpha)


def gaussian_sample_score_partials(mean, log_std, n, seed, offset, kernel,
                                   kernel_data, alpha=2.0, start=0):
    """K2: ``(lw (n,), partials (ceil(n / CHUNK), 6))`` for `n` draws of
    ``N(mean, diag(exp(log_std))^2)``, samples ``start .. start + n - 1``
    of the Philox stream of ``(seed, offset)`` (the rows `philox_normal`
    gives for the same `start`), scored by the model density named
    `kernel` (its data `kernel_data`).  Runs where `mean` lies."""
    _lw.check_tensor('mean', mean, None, None)
    if mean.dim() != 1:
        raise ValueError('mean must be 1-D')
    d = mean.shape[0]
    _lw.check_tensor('log_std', log_std, mean.dtype, mean.device, (d,))
    if n <= 0:
        raise ValueError('n must be positive, got {}'.format(n))
    _check_stream(seed, offset, start)
    _lw.check_kernel_model(kernel, kernel_data, d, mean.element_size())
    if mean.device.type == 'cpu':
        return gaussian_sample_score_partials_plain(
            mean, log_std, n, seed, offset, kernel, kernel_data, alpha,
            start)
    spec, _data = _lw.model_spec(kernel, kernel_data, mean.device,
                                 mean.dtype)
    lw = torch.empty((n,), dtype=mean.dtype, device=mean.device)
    partials = torch.empty((_lw.n_chunks(n), _lw.NPART), dtype=mean.dtype,
                           device=mean.device)
    _LIB.launch('gaussian_sample_score_partials', mean.device, mean.dtype,
                mean.data_ptr(), log_std.data_ptr(), n, d, seed, offset,
                start, float(alpha), ctypes.byref(spec), lw.data_ptr(),
                partials.data_ptr())
    return lw, partials


def philox_normal(n, d, seed, offset=0, start=0, dtype=torch.float32,
                  device='cpu'):
    """Standard normals z (n, d) of samples ``start .. start + n - 1`` of
    the Philox stream of ``(seed, offset)``: the z that K2 draws in-kernel
    for those samples."""
    device = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError('dtype must be float32 or float64, got {}'
                        .format(dtype))
    if n < 0 or d < 1:
        raise ValueError('need n >= 0 and d >= 1, got {} and {}'
                         .format(n, d))
    _check_stream(seed, offset, start)
    if device.type == 'cpu':
        return philox_normal_plain(n, d, seed, offset, start, dtype, device)
    if device.type != 'cuda':
        raise ValueError('only cpu and cuda are supported, got {}'
                         .format(device))
    z = torch.empty((n, d), dtype=dtype, device=device)
    if n:
        _LIB.launch('philox_normal', z.device, dtype, n, d, start, seed,
                    offset, z.data_ptr())
    return z


def philox_bits(counters, seed):
    """Philox4x32-10 of each row of ``counters`` (m, 4) int64 (uint32
    values) under the 64-bit key `seed`, on the card: (m, 4) int64."""
    if counters.device.type != 'cuda' or counters.dim() != 2 \
            or counters.shape[1] != 4:
        raise ValueError('counters must be (m, 4) on a CUDA device')
    _check_stream(seed, 0, 0)
    # uint32 values as the int32 of the same bits
    c32 = (counters - ((counters >> 31) << 32)).to(torch.int32).contiguous()
    out = torch.empty_like(c32)
    with torch.cuda.device(counters.device):
        rc = _LIB.lib.philox_bits(
            c32.data_ptr(), c32.shape[0], seed, out.data_ptr(),
            torch.cuda.current_stream(counters.device).cuda_stream)
    if rc != 0:
        raise RuntimeError('philox_bits launch failed: CUDA error {}'
                           .format(rc))
    return out.to(torch.int64) & 0xFFFFFFFF
