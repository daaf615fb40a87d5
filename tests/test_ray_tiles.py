"""Ray tile engine: differential tests vs the LVT walk / brute force."""

import numpy as np
import jax.numpy as jnp
import pytest

import implicitbvh_tpu as ib
from implicitbvh_tpu.raytrace import traverse_rays
from implicitbvh_tpu.traverse import TileTraversal, traverse_rays_tiles, \
    traverse_rays_tiles_fixed


def random_scene(n, seed, scale=None):
    rng = np.random.default_rng(seed)
    scale = scale or float(n) ** (1.0 / 3.0) * 1.5
    xs = rng.random((n, 3)).astype(np.float32) * scale
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    return xs, rs


def random_rays(nrays, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    p = (rng.random((3, nrays)).astype(np.float32) * (scale + 3) - 1.5)
    d = (rng.random((3, nrays)).astype(np.float32) - 0.5)
    return p, d


def contacts_set(t):
    return set(t.contacts_list())


def test_ray_tiles_matches_lvt_sphere_leaves():
    xs, rs = random_scene(300, 0)
    p, d = random_rays(77, 1, scale=float(300) ** (1 / 3) * 1.5)
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    ref = contacts_set(traverse_rays(bvh, p, d))
    got = contacts_set(traverse_rays_tiles(bvh, p, d))
    assert got == ref
    assert len(ref) > 0


def test_ray_tiles_matches_lvt_box_leaves():
    rng = np.random.default_rng(3)
    n = 200
    lo = rng.random((n, 3)).astype(np.float32) * 8
    up = lo + rng.random((n, 3)).astype(np.float32) * 0.7
    p, d = random_rays(50, 4, scale=8.0)
    bvh = ib.build(ib.BBox(jnp.asarray(lo), jnp.asarray(up)), ib.BBox)
    ref = contacts_set(traverse_rays(bvh, p, d))
    got = contacts_set(traverse_rays_tiles(bvh, p, d))
    assert got == ref
    assert len(ref) > 0


def test_ray_tiles_dispatch_via_traverse_rays():
    xs, rs = random_scene(100, 5)
    p, d = random_rays(33, 6)
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    ref = contacts_set(traverse_rays(bvh, p, d))
    got = contacts_set(traverse_rays(bvh, p, d, TileTraversal()))
    assert got == ref


def test_ray_tiles_axis_aligned_and_zero_direction_components():
    # rays exactly along axes with zero components exercise the 0 * inf
    # slab-test NaN semantics; must match the reference-parity walk engine
    xs = np.array([[0, 0, z] for z in range(6)], np.float32)
    rs = np.full(6, 0.4, np.float32)
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    p = np.array([[0.0, 0.0, 10.0], [0.0, 0.0, 0.0], [-5.0, 20.0, 2.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0], [1.0, 1.0, 0.0]],
                 np.float32)
    ref = contacts_set(traverse_rays(bvh, p, d))
    got = contacts_set(traverse_rays_tiles(bvh, p, d))
    assert got == ref
    # first ray hits everything, second hits nothing (points away)
    assert {(i, 1) for i in range(1, 7)} <= got


def test_ray_tiles_narrow_predicate():
    xs, rs = random_scene(120, 7)
    p, d = random_rays(40, 8)
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)

    def narrow(leaf, pp, dd):
        return leaf.index % 2 == 0

    ref = contacts_set(traverse_rays(bvh, p, d, narrow=narrow))
    got = contacts_set(traverse_rays_tiles(bvh, p, d, narrow=narrow))
    assert got == ref
    assert all(i % 2 == 0 for i, _ in got)


def test_ray_tiles_fixed_overflow_flag():
    xs, rs = random_scene(64, 9, scale=2.0)
    p, d = random_rays(32, 10, scale=2.0)
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    total, contacts, overflow, _nc = traverse_rays_tiles_fixed(bvh, p, d, 4)
    if int(total) > 4:
        assert bool(overflow)
    # dense scene with ample capacity: exact parity of the valid prefix
    total2, contacts2, overflow2, _nc2 = traverse_rays_tiles_fixed(
        bvh, p, d, 1 << 12)
    assert not bool(overflow2)
    ref = contacts_set(traverse_rays(bvh, p, d))
    got = {tuple(map(int, r)) for r in np.asarray(contacts2[:int(total2)])}
    assert got == ref


def test_ray_tiles_more_rays_than_leaves():
    xs, rs = random_scene(40, 11)
    p, d = random_rays(300, 12)
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    ref = contacts_set(traverse_rays(bvh, p, d))
    got = contacts_set(traverse_rays_tiles(bvh, p, d))
    assert got == ref


def test_ray_tiles_fine_bands():
    """bands=16 on the ray tile path must match the walk exactly (finer
    ray bands only shrink the tested superset)."""
    from implicitbvh_tpu.traverse.ray_tiles import traverse_rays_tiles_fixed
    from implicitbvh_tpu.raytrace import traverse_rays_fixed
    rng = np.random.default_rng(21)
    n, nrays = 400, 96
    xs = (rng.random((n, 3)) * 8).astype(np.float32)
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    sp = ib.BSphere(tuple(jnp.asarray(xs[:, k]) for k in range(3)),
                    jnp.asarray(rs))
    bvh = ib.build(sp, ib.BBox)
    p = jnp.asarray((rng.random((3, nrays)) * 8).astype(np.float32))
    d = jnp.asarray((rng.random((3, nrays)) - 0.5).astype(np.float32))
    wt, wc = traverse_rays_fixed(bvh, p, d, capacity=4096)
    walk = {tuple(map(int, r)) for r in np.asarray(wc)[:int(wt)]}
    alg = TileTraversal(tile=32, bands=16)
    total, contacts, ov, _nc = traverse_rays_tiles_fixed(
        bvh, p, d, capacity=1024, alg=alg)
    assert int(ov) == 0
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    assert got == walk
