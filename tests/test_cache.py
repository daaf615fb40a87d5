"""Cache-reuse semantics of the convenience traversal API.

The reference makes per-step rebuild/retraversal allocation-free through
``cache=`` on the user-facing entry points (ref src/build.jl:232-263,
src/traverse/leaf_vs_tree/traverse_single.jl:76-89).  The XLA analogue:
``traverse(..., cache=prev)`` re-uses the previous result's compiled
capacities, so a moving-geometry loop with repeating shapes performs ZERO
new compiles after the first step.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import implicitbvh_tpu as ib
from implicitbvh_tpu.traverse import traverse
from implicitbvh_tpu.traverse import lvt as _lvt
from implicitbvh_tpu.traverse.tiles import (TileTraversal,
                                            traverse_tiles_fixed)


def _spheres(n, seed, r=0.6):
    rng = np.random.default_rng(seed)
    c = (rng.random((n, 3)) * float(n) ** (1 / 3)).astype(np.float32)
    xs = tuple(jnp.asarray(c[:, k]) for k in range(3))
    return ib.BSphere(xs, jnp.full((n,), np.float32(r)))


def _brute(vol):
    n = vol.r.shape[0]
    xs = np.stack([np.asarray(c) for c in vol.xs], axis=1)
    r = np.asarray(vol.r)
    out = set()
    for i in range(n):
        d2 = ((xs[i] - xs[i + 1:]) ** 2).sum(1)
        rr = (r[i] + r[i + 1:]) ** 2
        for j in np.nonzero(d2 <= rr)[0]:
            out.add((i + 1, int(i + 2 + j)))
    return sorted(out)


def test_lvt_cache_reuse_zero_recompiles():
    vol1 = _spheres(60, 0, r=1.0)        # contact-rich -> larger capacity
    vol2 = _spheres(60, 1, r=0.4)        # fewer contacts, same shapes
    t1 = traverse(ib.build(vol1, ib.BBox))
    size0 = _lvt.lvt_write_single._cache_size()
    t2 = traverse(ib.build(vol2, ib.BBox), cache=t1)
    assert _lvt.lvt_write_single._cache_size() == size0, \
        "cache= must re-use the previous write-pass capacity"
    assert t2.cache1.shape[0] == t1.cache1.shape[0]
    assert sorted(map(tuple, t2.contacts_list())) == _brute(vol2)


def test_tile_cache_reuse_zero_recompiles():
    # vol1 is dense enough to force one contact-capacity growth (its grown
    # capacity is then carried in the cache), vol2 is sparse with the same
    # shapes
    vol1 = _spheres(70, 2, r=0.6)
    vol2 = _spheres(70, 3, r=0.15)
    alg = TileTraversal()
    t1 = traverse(ib.build(vol1, ib.BBox), alg)
    assert t1.cache1.shape[0] > 128          # grown from max(64, 70) -> 128
    size0 = traverse_tiles_fixed._cache_size()
    t2 = traverse(ib.build(vol2, ib.BBox), alg, cache=t1)
    assert traverse_tiles_fixed._cache_size() == size0
    assert t2.pair_capacity == t1.pair_capacity
    assert t2.cache1.shape[0] == t1.cache1.shape[0]
    assert sorted(map(tuple, t2.contacts_list())) == _brute(vol2)


def test_tile_knobs_round_trip_growth_and_merge():
    """Every TileTraversal knob must survive capacity growth and
    ``cache=`` reuse: the result records the configuration that produced
    it, and a cached rerun keeps the user's knobs and capacities."""
    import dataclasses

    alg = TileTraversal(tile=32, bands=8)
    vol = _spheres(70, 2, r=0.6)
    t1 = traverse(ib.build(vol, ib.BBox), alg)
    assert t1.cache1.shape[0] > 128           # growth happened
    for f in dataclasses.fields(TileTraversal):
        assert getattr(t1.tile_alg, f.name) == getattr(alg, f.name), f.name
    t2 = traverse(ib.build(vol, ib.BBox), alg, cache=t1)
    assert t2.tile_alg == alg
    assert t2.cache1.shape == t1.cache1.shape
    assert sorted(map(tuple, t2.contacts_list())) == _brute(vol)


def test_tile_density_fallback():
    """A scene where ~every pair is in contact (one tile pair holding
    thousands of contacts) must produce the exact contact set: the emit
    pass has no per-pair slot caps."""
    vol = _spheres(70, 2, r=1.2)       # ~all 2415 pairs in contact
    t = traverse(ib.build(vol, ib.BBox), TileTraversal())
    assert isinstance(t.tile_alg, TileTraversal)
    assert sorted(map(tuple, t.contacts_list())) == _brute(vol)


def test_ray_cache_reuse():
    vol = _spheres(60, 4, r=0.8)
    bvh = ib.build(vol, ib.BBox)
    rng = np.random.default_rng(5)
    p = jnp.asarray(rng.random((3, 32)).astype(np.float32) * 4.0)
    d = jnp.asarray((rng.random((3, 32)) - 0.5).astype(np.float32))
    t1 = ib.traverse_rays(bvh, p, d)
    t2 = ib.traverse_rays(bvh, p * 1.01, d, cache=t1)
    assert t2.cache1.shape[0] == t1.cache1.shape[0]
    a = sorted(map(tuple, t1.contacts_list()))
    b = sorted(map(tuple, ib.traverse_rays(bvh, p, d).contacts_list()))
    assert a == b
