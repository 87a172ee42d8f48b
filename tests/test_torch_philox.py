"""The port's Philox4x32-10 normal stream (plain version), on the CPU.

Random123's known-answer vectors hold both the tensor version and a
pure-Python Philox written here from the algorithm's definition; the
stream is deterministic, its (seed, offset) streams are disjoint, any
range of samples can be drawn alone, and its normals pass a KS test
against N(0, 1).  The CUDA kernels' agreement with this version is held on
the card (tests/test_torch_kernels.py).
"""
import math

import numpy as np
import pytest
import torch
from scipy import stats

from viabel_tpu_torch.ops import gaussian_lw, philox

MASK = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32-10: counter, key, expected output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK,) * 4, (MASK, MASK),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def philox_python(counter, key, rounds=10):
    """Philox4x32 on Python integers."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
    return c0, c1, c2, c3


@pytest.mark.parametrize('counter,key,want', KAT)
def test_known_answers(counter, key, want):
    assert philox_python(counter, key) == want
    got = philox.philox4x32(counter, key)
    assert tuple(int(v) for v in got) == want


def test_tensor_philox_matches_python_on_large_words():
    """Words at and above 2^31, where a plain int64 product overflows."""
    rs = np.random.RandomState(0)
    counters = rs.randint(0, 2 ** 32, (200, 4), dtype=np.int64)
    counters[:50] |= 0x80000000
    key = (0xFFFFFFF0, 0x80000001)
    got = philox.philox4x32(tuple(torch.as_tensor(counters[:, j])
                                  for j in range(4)), key)
    got = torch.stack(got, dim=1).numpy()
    for row, c in zip(got, counters):
        assert tuple(row) == philox_python(tuple(int(v) for v in c), key)


def _stream_python(seed, offset, sample, d):
    """The stream's normals of one sample, in Python floats (f64)."""
    out = []
    for g in range(-(-d // 4)):
        words = philox_python((sample & MASK, g, offset, sample >> 32),
                              (seed & MASK, seed >> 32))
        u = [1.0 - (w >> 8) * 2.0 ** -24 for w in words]
        for a, b in ((u[0], u[1]), (u[2], u[3])):
            r = math.sqrt(-2.0 * math.log(a))
            out += [r * math.cos(2 * math.pi * b), r * math.sin(2 * math.pi * b)]
    return out[:d]


@pytest.mark.parametrize('d', [1, 4, 10, 13])
def test_stream_layout(d):
    seed, offset = 2 ** 63 + 977, 3
    z = philox.philox_normal_plain(5, d, seed, offset, start=2 ** 32 - 2,
                                   dtype=torch.float64)
    for i in range(5):
        np.testing.assert_allclose(
            z[i].numpy(), _stream_python(seed, offset, 2 ** 32 - 2 + i, d),
            rtol=1e-13, atol=1e-13)


def test_deterministic_and_ranges_agree():
    a = philox.philox_normal_plain(1000, 10, 42, 1, dtype=torch.float64)
    b = philox.philox_normal_plain(1000, 10, 42, 1, dtype=torch.float64)
    assert torch.equal(a, b)
    part = philox.philox_normal_plain(300, 10, 42, 1, start=500,
                                      dtype=torch.float64)
    assert torch.equal(part, a[500:800])
    # the float32 stream rounds the same uniforms
    a32 = philox.philox_normal_plain(1000, 10, 42, 1, dtype=torch.float32)
    np.testing.assert_allclose(a32.numpy(), a.numpy(), rtol=0, atol=2e-6)


def test_streams_are_disjoint():
    base = philox.philox_normal_plain(2000, 6, 7, 0, dtype=torch.float64)
    others = [philox.philox_normal_plain(2000, 6, 7, 1, dtype=torch.float64),
              philox.philox_normal_plain(2000, 6, 8, 0, dtype=torch.float64),
              philox.philox_normal_plain(2000, 6, 7 + 2 ** 32, 0,
                                         dtype=torch.float64)]
    values = set(base.flatten().tolist())
    for o in others:
        assert not values & set(o.flatten().tolist())
        r = np.corrcoef(base.flatten().numpy(), o.flatten().numpy())[0, 1]
        assert abs(r) < 0.05


def test_normals_pass_ks():
    z = philox.philox_normal_plain(10 ** 4, 10, 12345, 0,
                                   dtype=torch.float64).flatten().numpy()
    assert z.shape == (10 ** 5,)
    assert stats.kstest(z, 'norm').pvalue > 1e-3
    # each coordinate of the group (cos and sin halves) is N(0, 1) too
    zz = z.reshape(-1, 10)
    for j in range(10):
        assert stats.kstest(zz[:, j], 'norm').pvalue > 1e-4
    assert np.abs(np.corrcoef(zz.T) - np.eye(10)).max() < 0.05


def test_seed_from_generator_and_validation():
    s1 = philox.philox_seed(torch.Generator().manual_seed(0))
    s2 = philox.philox_seed(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    s3, s4 = philox.philox_seed(g), philox.philox_seed(g)
    assert s1 == s2 == s3 != s4
    assert all(0 <= s < 2 ** 64 for s in (s1, s4))
    with pytest.raises(ValueError):
        philox.philox_normal_plain(3, 2, -1)
    with pytest.raises(ValueError):
        philox.philox_normal_plain(3, 2, 0, offset=2 ** 32)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    before = dict(gaussian_lw.launches)
    z = gaussian_lw.philox_normal(100, 7, 99, 2, 10, torch.float64, 'cpu')
    assert torch.equal(z, philox.philox_normal_plain(100, 7, 99, 2, 10,
                                                     torch.float64))
    assert gaussian_lw.launches == before
    with pytest.raises(TypeError):
        gaussian_lw.philox_normal(10, 2, 0, dtype=torch.float16)
