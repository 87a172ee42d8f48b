"""The Philox4x32-10 normal stream, in plain PyTorch.

Plain version of the stream that the CUDA kernels draw from
(``csrc/bound_pass.cuh``): `philox_normal_plain` gives, bit for bit in
the uniforms, the z that ``philox_normal`` and the in-kernel draws of K2
(`ops.gaussian_lw`) make, so the CPU runs the same draws as the card.

The stream of a ``(seed, offset)`` pair (seed 64-bit, offset 32-bit):
sample ``s`` (64-bit), group ``g`` of 4 normals runs Philox4x32-10
(Salmon, Moraes, Dror & Shaw 2011, Random123's constants) with key
``(seed lo, seed hi)`` and counter ``(s lo, g, offset, s hi)``.  Its four
words become four uniforms in (2^-24, 1] as the TPU kernel's
``_uniform_from_bits`` made them (viabel_tpu/ops/sample_score.py:152-161
at 2e6dc2c^), and Box-Muller (:164-168 there) turns each pair into two
normals ``r cos t, r sin t`` (the TPU kept only the cosine), so coordinate
``4g + q`` of sample s is normal q of group g.  Because the counter names
the sample, any range of samples can be drawn on its own.

Integers live in int64 tensors holding uint32 values.  A 32 x 32-bit
product overflows int64 when both factors reach 2^31, so `_mulhilo`
multiplies by the constant's 16-bit halves.
"""
import math

import torch

from .._trace import to_host

__all__ = ['philox4x32', 'uniform_from_bits', 'box_muller',
           'philox_normal_plain', 'philox_seed', 'fold_in', 'MAX_SEED']

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK = 0xFFFFFFFF
MAX_SEED = 2 ** 64 - 1
_GOLDEN_GAMMA = 0x9E3779B97F4A7C15


def _mulhilo(a, m):
    """``(hi, lo)`` 32-bit words of ``a * m`` for an int64 tensor ``a`` of
    uint32 values and a uint32 constant ``m``; every partial product stays
    below 2^49."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key, rounds=10):
    """Philox4x32-``rounds`` of a counter (4 int64 tensors or ints of
    uint32 values) under a key (2 ints); returns 4 int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK, (k1 + PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits, dtype):
    """Uniforms in (2^-24, 1] from the top 24 bits of uint32 words: exact
    in float32 and float64."""
    return 1.0 - (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def box_muller(b0, b1, dtype):
    """Two normals from two words: ``r cos t, r sin t`` with
    ``r = sqrt(-2 log u0)`` and ``t = 2 pi u1``."""
    r = torch.sqrt(-2.0 * torch.log(uniform_from_bits(b0, dtype)))
    t = (2.0 * math.pi) * uniform_from_bits(b1, dtype)
    return r * torch.cos(t), r * torch.sin(t)


def _check_stream(seed, offset, start):
    if not 0 <= seed <= MAX_SEED:
        raise ValueError('seed must be in [0, 2^64), got {}'.format(seed))
    if not 0 <= offset <= _MASK:
        raise ValueError('offset must be in [0, 2^32), got {}'.format(offset))
    if start < 0:
        raise ValueError('start must be >= 0, got {}'.format(start))


def philox_normal_plain(n, d, seed, offset=0, start=0, dtype=torch.float32,
                        device='cpu'):
    """Plain version of ``philox_normal``: standard normals z (n, d) of
    samples ``start .. start + n - 1`` of the ``(seed, offset)`` stream."""
    _check_stream(seed, offset, start)
    s = torch.arange(start, start + n, dtype=torch.int64, device=device)
    key = (seed & _MASK, seed >> 32)
    cols = []
    for g in range(-(-d // 4)):
        bits = philox4x32((s & _MASK, g, offset, s >> 32), key)
        cols.extend(box_muller(bits[0], bits[1], dtype))
        cols.extend(box_muller(bits[2], bits[3], dtype))
    return torch.stack(cols[:d], dim=1)


def philox_seed(generator):
    """A 64-bit Philox seed drawn from ``generator`` (which it advances),
    as the port's kernels take their randomness from a `torch.Generator`.
    A CPU and a CUDA generator seeded alike give different seeds."""
    hi, lo = to_host(torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                                   generator=generator,
                                   device=generator.device)).tolist()
    return (hi << 32) | lo


def fold_in(seed, i):
    """A 64-bit seed for item ``i`` of the stream that the 64-bit `seed`
    names, the counterpart of ``jax.random.fold_in(key, i)``: splitmix64
    (Steele, Lea & Flood 2014) of ``seed + (i + 1) * golden gamma``, so
    distinct items of one seed, and the items of distinct seeds, get
    well-mixed, distinct seeds."""
    z = (seed + (i + 1) * _GOLDEN_GAMMA) & MAX_SEED
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MAX_SEED
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MAX_SEED
    return z ^ (z >> 31)
