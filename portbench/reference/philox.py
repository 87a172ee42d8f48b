"""The Philox4x32-10 normal stream, written from its definition (Salmon,
Moraes, Dror & Shaw 2011, Random123's constants) in NumPy.

The multistart entry point perturbs its starts with normals of this
stream: sample ``s`` (64-bit), group ``g`` of four normals is Philox of
the counter ``(s lo, g, offset, s hi)`` under the key ``(seed lo, seed
hi)``; each word's top 24 bits give a uniform ``u = 1 - (w >> 8) 2^-24``
in (2^-24, 1], and Box-Muller turns the pairs (w0, w1), (w2, w3) into the
normals ``r cos t, r sin t`` (``r = sqrt(-2 log u_a)``, ``t = 2 pi u_b``),
coordinates 4g to 4g + 3 of the sample.  The integers are exact; the
normals are worked out here in float64.
"""
import numpy as np

M = (0xD2511F53, 0xCD9E8D57)
W = (0x9E3779B9, 0xBB67AE85)
MASK = 0xFFFFFFFF


def philox4x32(counter, key, rounds=10):
    """Philox4x32-``rounds`` of four uint64 arrays of 32-bit words under a
    key of two ints; returns four uint64 arrays."""
    c0, c1, c2, c3 = (np.asarray(c, dtype=np.uint64) for c in counter)
    k0, k1 = key
    mask = np.uint64(MASK)
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + W[0]) & MASK, (k1 + W[1]) & MASK
        p0 = c0 * np.uint64(M[0])
        p1 = c2 * np.uint64(M[1])
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0),
                          p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1),
                          p0 & mask)
    return c0, c1, c2, c3


def _uniform(w):
    return 1.0 - (w >> np.uint64(8)).astype(np.float64) * 2.0 ** -24


def normal(n, d, seed, offset=0):
    """(n, d) float64 normals of samples 0 .. n - 1 of the stream of
    ``(seed, offset)``."""
    s = np.arange(n, dtype=np.uint64)
    key = (seed & MASK, seed >> 32)
    cols = []
    for g in range(-(-d // 4)):
        w = philox4x32((s & np.uint64(MASK), np.full(n, g, np.uint64),
                        np.full(n, offset, np.uint64), s >> np.uint64(32)),
                       key)
        for a, b in ((w[0], w[1]), (w[2], w[3])):
            r = np.sqrt(-2.0 * np.log(_uniform(a)))
            t = 2.0 * np.pi * _uniform(b)
            cols.extend((r * np.cos(t), r * np.sin(t)))
    return np.stack(cols[:d], axis=1)
