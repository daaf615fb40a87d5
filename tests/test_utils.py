"""Unit tests for utils: math helpers and pair unranking.

Port of reference test coverage /root/reference/test/runtests.jl:17-120.
"""

import numpy as np
import jax.numpy as jnp

from implicitbvh_tpu.utils import (count_trailing_zeros, floor_ilog2,
                                   ilog2_static, k2ij_exclusive,
                                   k2ij_inclusive, trailing_ones)
from implicitbvh_tpu.volumes import dist3, dist3sq, dot3


def test_ilog2_static():
    for n in range(1, 300):
        assert ilog2_static(n) == int(np.log2(n))
    assert ilog2_static(4, round_up=True) == 2
    assert ilog2_static(5, round_up=True) == 3
    assert ilog2_static(1) == 0


def test_floor_ilog2_traced():
    v = jnp.arange(1, 5000, dtype=jnp.int32)
    got = np.asarray(floor_ilog2(v))
    want = np.floor(np.log2(np.arange(1, 5000))).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_ctz_and_trailing_ones():
    v = jnp.arange(1, 4097, dtype=jnp.int32)
    got = np.asarray(count_trailing_zeros(v))
    want = np.array([(int(x) & -int(x)).bit_length() - 1 for x in range(1, 4097)])
    np.testing.assert_array_equal(got, want)
    t = np.asarray(trailing_ones(v))
    want_t = []
    for x in range(1, 4097):
        c = 0
        while x & 1:
            c += 1
            x >>= 1
        want_t.append(c)
    np.testing.assert_array_equal(t, np.array(want_t))


def test_scalar_math():
    # volumes.py keeps these in coordinate-tuple SoA form (the package layout)
    x = tuple(jnp.asarray(np.array(v)) for v in ([1.0, 0.5], [2.0, -1.0],
                                                 [3.0, 2.0]))
    y = tuple(jnp.asarray(np.array(v)) for v in ([4.0, 1.0], [5.0, 1.0],
                                                 [6.0, 1.0]))
    np.testing.assert_allclose(np.asarray(dot3(x, y)), [32.0, 1.5])
    np.testing.assert_allclose(np.asarray(dist3sq(x, y)),
                               [27.0, 0.25 + 4.0 + 1.0])
    np.testing.assert_allclose(np.asarray(dist3(x, y)),
                               np.sqrt([27.0, 5.25]))


def _k2ij_bruteforce(n, inclusive):
    pairs = []
    for i in range(n):
        for j in range(i if not inclusive else i, n):
            if not inclusive and j == i:
                continue
            pairs.append((i, j))
    return pairs


def test_k2ij_inclusive_exhaustive():
    # Ref sweeps n up to 5000 with scalar loops (runtests.jl:57-120); we do
    # the same correctness check fully vectorized.
    for n in (1, 2, 3, 7, 100, 911, 5000):
        total = n * (n + 1) // 2
        k = jnp.arange(total, dtype=jnp.int32)
        i, j = k2ij_inclusive(n, k)
        i, j = np.asarray(i), np.asarray(j)
        want = [(a, b) for a in range(n) for b in range(a, n)]
        got = list(zip(i.tolist(), j.tolist()))
        assert got == want, f"n={n}"


def test_k2ij_exclusive_exhaustive():
    for n in (2, 3, 7, 100, 911, 5000):
        total = n * (n - 1) // 2
        k = jnp.arange(total, dtype=jnp.int32)
        i, j = k2ij_exclusive(n, k)
        i, j = np.asarray(i), np.asarray(j)
        want = [(a, b) for a in range(n) for b in range(a + 1, n)]
        got = list(zip(i.tolist(), j.tolist()))
        assert got == want, f"n={n}"


def test_k2ij_int64():
    n = 3000
    total = n * (n + 1) // 2
    k = jnp.arange(total, dtype=jnp.int64)
    i, j = k2ij_inclusive(n, k)
    assert i.dtype == jnp.int64
    s = np.asarray(i).astype(np.int64) * n - (np.asarray(i) * (np.asarray(i) - 1)) // 2
    np.testing.assert_array_equal(s + (np.asarray(j) - np.asarray(i)),
                                  np.arange(total))
