"""The Student-t and chi-square samplers' arithmetic after their generator
calls, with its plain version.

``t_from_uniforms`` of ``csrc/t_sample.cu`` (see the note at its top)
takes one group of at most `GROUP` uniform buffers of the rejection-free
construction (`distributions.student_t_sample`, `chi2_sample`) and updates
one ``total`` buffer in place: ``total - log(prod max(u, tiny))``; the last
group's launch writes chi2 (``2 total``, plus ``z1 z1`` for odd df) or the t
draws ``z sqrt(df / chi2)`` there instead.  `distributions` makes the
generator calls, in their order, between the launches.

`t_from_uniforms_plain` is the same step in PyTorch, the composition the
samplers ran before the kernel, operation for operation; the kernel rounds
each operation as it does, so the two agree bit for bit.  `takes` is the
rule: a CUDA float32 or float64 draw takes the kernel, anything else the
plain version.
"""
import ctypes

import torch

from ._launch import SUFFIX, Library

__all__ = ['GROUP', 'takes', 't_from_uniforms', 't_from_uniforms_plain']

# uniforms a product before its log: the exact construction's grouping
# (viabel_tpu/distributions.py:42-62), and the most a launch takes
GROUP = 10

_ptr = ctypes.c_void_p
# the group's pointers (a host array), their count, total, z, z1, numel,
# df, first, last
_SIGNATURES = {'t_from_uniforms': [
    ctypes.POINTER(_ptr), ctypes.c_int, _ptr, _ptr, _ptr, ctypes.c_longlong,
    ctypes.c_double, ctypes.c_int, ctypes.c_int]}
_LIB = Library('t_sample', _SIGNATURES)


def takes(device, dtype):
    """Whether a draw on `device` in `dtype` takes the kernel."""
    return torch.device(device).type == 'cuda' and dtype in SUFFIX


def _check(name, t, total):
    if (not isinstance(t, torch.Tensor) or t.dtype != total.dtype
            or t.device != total.device or t.shape != total.shape
            or not t.is_contiguous()):
        raise ValueError('{} must be a contiguous {} tensor of shape {} on '
                         '{}'.format(name, total.dtype, tuple(total.shape),
                                     total.device))
    if t.data_ptr() % 16:
        raise ValueError('{} must start on a 16-byte boundary (the kernel '
                         'loads 16 bytes at a time)'.format(name))


def t_from_uniforms(uniforms, total, first, last, z=None, z1=None, df=None):
    """One group's launch: `uniforms` (a list of at most `GROUP` tensors
    shaped as `total`) into `total` in place, which the first group reads
    as 0; with `last`, `total` then holds chi2 (no `z`) or the t draws
    ``z sqrt(df / chi2)``, ``z1 z1`` added to chi2 where given (odd df);
    before the last group `z` and `z1` are not read.
    Every buffer starts on a 16-byte boundary, as the allocator's blocks
    do.  Returns `total`.  The launch reads the buffers on the current
    stream, so they may be dropped after the call."""
    if not takes(total.device, total.dtype):
        raise TypeError('t_from_uniforms takes CUDA float32 or float64 '
                        'tensors, got {} on {}'.format(total.dtype,
                                                       total.device))
    _check('total', total, total)
    if len(uniforms) > GROUP or not (uniforms or (first and last)):
        raise ValueError('a launch takes 1 to {} uniforms (none only in a '
                         'draw\'s one launch), got {}'.format(GROUP,
                                                              len(uniforms)))
    for i, u in enumerate(uniforms):
        _check('uniforms[{}]'.format(i), u, total)
    for name, t in (('z', z), ('z1', z1)):
        if t is not None:
            _check(name, t, total)
    if last and z is not None and df is None:
        raise ValueError('the t form needs df')
    ptrs = (_ptr * GROUP)(*[u.data_ptr() for u in uniforms])
    _LIB.launch('t_from_uniforms', total.device, total.dtype, ptrs,
                len(uniforms), total.data_ptr(),
                None if z is None else z.data_ptr(),
                None if z1 is None else z1.data_ptr(), total.numel(),
                float(df or 0), int(first), int(last))
    return total


def t_from_uniforms_plain(uniforms, total, first, last, z=None, z1=None,
                          df=None):
    """Plain version of `t_from_uniforms`: the same step in PyTorch, on any
    device.  Returns the group's total (updated in place), or after the
    last group chi2 or the t draws as new tensors."""
    if first:
        total.zero_()
    if uniforms:
        tiny = torch.finfo(total.dtype).tiny
        prod = torch.ones_like(total)
        for u in uniforms:
            prod.mul_(u.clamp_min(tiny))
        total.sub_(torch.log(prod))
    if not last:
        return total
    chi2 = 2.0 * total
    if z1 is not None:
        chi2 = chi2 + z1 * z1
    return chi2 if z is None else z * torch.sqrt(df / chi2)
