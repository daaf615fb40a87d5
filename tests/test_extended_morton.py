"""ExtendedMortonAlgorithm (Vinkler et al. HPG'17) behavior tests.

Reference counterpart: /root/reference/src/morton/extended.jl (gated off
upstream); schedule and defaults checked against its documented rules.
"""

import numpy as np
import jax.numpy as jnp

import implicitbvh_tpu as ib
from implicitbvh_tpu.morton import (ExtendedMortonAlgorithm,
                                    _extended_schedule,
                                    bounding_volumes_extrema,
                                    morton_encode_extended)


def _vol(n, seed=0, stretch=(1.0, 1.0, 1.0), r=0.3):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)).astype(np.float32) * np.float32(n ** (1 / 3))
    c *= np.asarray(stretch, np.float32)
    xs = tuple(jnp.asarray(c[:, k]) for k in range(3))
    return ib.BSphere(xs, jnp.full((n,), np.float32(r)))


def test_defaults_per_width():
    # ref _default_size_interval/_default_size_budget (extended.jl:205-212)
    a16 = ExtendedMortonAlgorithm(bits=16)
    assert (a16.size_interval, a16.size_budget, a16.size_slots) == (0, 0, ())
    a32 = ExtendedMortonAlgorithm(bits=32)
    assert a32.size_budget == 4
    # 1-based positions 7, 14, 21, 28 (idx % 7 == 0)
    assert a32.size_slots == (6, 13, 20, 27)
    a64 = ExtendedMortonAlgorithm(bits=64)
    assert a64.size_budget == 6
    assert len(a64.size_slots) == 6
    # disabling the interval disables size bits entirely
    a0 = ExtendedMortonAlgorithm(bits=32, size_interval=0, size_budget=9)
    assert a0.size_budget == 0 and a0.size_slots == ()


def test_schedule_longest_axis_split():
    # an axis 8x longer than the others gets ~3 more bits (each split
    # halves it): cube case splits evenly
    alg = ExtendedMortonAlgorithm(bits=32, size_interval=0)
    axes, counts = _extended_schedule(
        (jnp.float32(8.0), jnp.float32(1.0), jnp.float32(1.0)), alg)
    c = np.asarray(counts)
    assert c.sum() == 32
    # 3 extra splits go to the 8x axis before the lengths equalize, after
    # which the remaining bits round-robin (first-max tie break)
    assert c[0] - c[1] == 3
    assert 0 <= c[1] - c[2] <= 1
    _, counts_cube = _extended_schedule(
        (jnp.float32(2.0), jnp.float32(2.0), jnp.float32(2.0)), alg)
    cc = np.asarray(counts_cube)
    assert cc.sum() == 32 and cc.max() - cc.min() <= 1


def test_size_bits_distinguish_extent():
    # same centers, different radii -> different codes iff size bits on
    n = 8
    xs = tuple(jnp.asarray(np.linspace(0, 10, n).astype(np.float32))
               for _ in range(3))
    small = ib.BSphere(xs, jnp.full((n,), 0.01, jnp.float32))
    big = ib.BSphere(xs, jnp.full((n,), 5.0, jnp.float32))
    alg = ExtendedMortonAlgorithm(bits=32)
    c_small = np.asarray(morton_encode_extended(small, alg))
    c_big = np.asarray(morton_encode_extended(big, alg))
    assert (c_small != c_big).any()
    alg_off = ExtendedMortonAlgorithm(bits=32, size_interval=0)
    assert (np.asarray(morton_encode_extended(small, alg_off)) ==
            np.asarray(morton_encode_extended(big, alg_off))).all()


def test_u64_pair_and_u16():
    import jax
    vol = _vol(64, seed=1)
    hl = morton_encode_extended(vol, ExtendedMortonAlgorithm(bits=64))
    if jax.config.jax_enable_x64:       # conftest enables x64 on CPU
        assert hl.dtype == jnp.uint64
    else:                               # no x64: (hi, lo) uint32 pair
        assert isinstance(hl, tuple) and hl[0].dtype == jnp.uint32
    c16 = morton_encode_extended(vol, ExtendedMortonAlgorithm(bits=16))
    assert c16.dtype == jnp.uint16


def test_build_traverse_with_extended_morton():
    """Contact sets are Morton-algorithm-independent: extended-Morton BVH
    traversal must match the default-Morton result exactly."""
    vol = _vol(150, seed=2, stretch=(20.0, 1.0, 1.0), r=0.5)
    opts = ib.BVHOptions(morton=ExtendedMortonAlgorithm(bits=32))
    t_ext = ib.traverse(ib.build(vol, ib.BBox, options=opts))
    t_def = ib.traverse(ib.build(vol, ib.BBox))
    assert (sorted(map(tuple, t_ext.contacts_list())) ==
            sorted(map(tuple, t_def.contacts_list())))


def test_build_quality_elongated_scene():
    """The point of extended codes (ref extended.jl:1-27, HPG'17): strictly
    better leaf locality on non-cubic scenes.  Proxy metric: mean
    Morton-neighbor center distance after the sort must improve at least
    2x over the default codes on a 100:1 scene (measured: ~9x, ratio
    0.111)."""
    vol = _vol(4000, seed=3, stretch=(100.0, 1.0, 1.0), r=0.1)

    def neighbor_cost(opts):
        bvh = ib.build(vol, ib.BBox, options=opts)
        xs = np.stack([np.asarray(c) for c in bvh.leaves.volume.xs], 1)
        return float(np.linalg.norm(np.diff(xs, axis=0), axis=1).mean())

    ext = neighbor_cost(ib.BVHOptions(
        morton=ExtendedMortonAlgorithm(bits=32, size_interval=0)))
    dflt = neighbor_cost(ib.BVHOptions())
    assert ext <= dflt * 0.5, (ext, dflt)
