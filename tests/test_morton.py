"""Morton encoding tests.

Port of reference coverage /root/reference/test/runtests.jl:471-591:
split3 bit patterns, extrema exclusivity, dtype combinations, degenerate
inputs.
"""

import numpy as np
import jax.numpy as jnp

from implicitbvh_tpu.morton import (DefaultMortonAlgorithm,
                                    bounding_volumes_extrema, morton_encode,
                                    morton_split3, MORTON_SCALING)
from implicitbvh_tpu.volumes import BSphere, center


def _spread_ref(v, bits_per_axis):
    out = 0
    for b in range(bits_per_axis):
        out |= ((v >> b) & 1) << (3 * b)
    return out


def test_split3_bit_patterns():
    for bits, per_axis in ((16, 5), (32, 10), (64, 21)):
        vals = [0, 1, 2, 3, 5, (1 << per_axis) - 1, 0b10101]
        dt = {16: jnp.uint16, 32: jnp.uint32, 64: jnp.uint64}[bits]
        got = np.asarray(morton_split3(jnp.asarray(vals, dt), bits))
        want = [_spread_ref(v & ((1 << per_axis) - 1), per_axis) for v in vals]
        np.testing.assert_array_equal(got.astype(np.uint64),
                                      np.asarray(want, np.uint64))


def test_extrema_exclusive():
    rng = np.random.default_rng(42)
    for dt in (np.float32, np.float64):
        c = jnp.asarray(rng.random((100, 3)).astype(dt) * 10 - 5)
        mins, maxs = bounding_volumes_extrema(c)
        assert (np.asarray(mins) < np.asarray(c).min(0)).all()
        assert (np.asarray(maxs) > np.asarray(c).max(0)).all()


def test_encode_monotone_along_z_line():
    # centers on a z line: codes must be strictly increasing in z
    xs = np.zeros((5, 3), np.float32)
    xs[:, 2] = np.arange(5)
    for bits in (16, 32, 64):
        m = morton_encode(jnp.asarray(xs), DefaultMortonAlgorithm(bits=bits))
        m = np.asarray(m).astype(np.uint64)
        assert (np.diff(m.astype(np.int64)) > 0).all()


def test_encode_fixed_bounds():
    alg = DefaultMortonAlgorithm(bits=32, compute_extrema=False,
                                 mins=(-1.0, -1.0, -1.0), maxs=(2.0, 2.0, 2.0))
    c = jnp.asarray(np.array([[0.5, 0.5, 0.5]], np.float32))
    m = int(np.asarray(morton_encode(c, alg))[0])
    scaling = MORTON_SCALING[32]
    q = int(0.5 * scaling)  # (0.5 - (-1)) / 3 = 0.5
    want = (_spread_ref(q, 10) << 2) | (_spread_ref(q, 10) << 1) | _spread_ref(q, 10)
    assert m == want


def test_encode_degenerate_identical_centers():
    c = jnp.asarray(np.zeros((7, 3), np.float32))
    m = np.asarray(morton_encode(c, DefaultMortonAlgorithm(bits=32)))
    assert (m == m[0]).all()  # all equal, no NaN/crash


def test_encode_single_volume():
    c = jnp.asarray(np.array([[1.0, 2.0, 3.0]], np.float32))
    m = morton_encode(c, DefaultMortonAlgorithm(bits=32))
    assert m.shape == (1,)


def test_u64_hi_lo_fallback_matches_native():
    # the no-x64 (hi, lo) packing must agree with native u64 encoding
    import jax
    from implicitbvh_tpu.morton import _split3_21bit_hi_lo, morton_split3_u64
    rng = np.random.default_rng(3)
    v = rng.integers(0, 1 << 21, size=100).astype(np.uint32)
    hi, lo = _split3_21bit_hi_lo(jnp.asarray(v))
    native = np.asarray(morton_split3_u64(jnp.asarray(v.astype(np.uint64))))
    packed = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    np.testing.assert_array_equal(packed, native)


def test_morton_order_locality():
    # sorting by morton must place near-identical points adjacently
    rng = np.random.default_rng(0)
    base = rng.random((50, 3)).astype(np.float32) * 100
    pts = np.concatenate([base, base + 1e-4], axis=0)
    m = np.asarray(morton_encode(jnp.asarray(pts),
                                 DefaultMortonAlgorithm(bits=32)))
    order = np.argsort(m, kind="stable")
    pos = np.empty(100, np.int64)
    pos[order] = np.arange(100)
    # each point and its twin must be adjacent after sorting
    assert (np.abs(pos[:50] - pos[50:]) == 1).all()
