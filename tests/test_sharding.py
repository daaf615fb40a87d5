"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import implicitbvh_tpu as ib
from implicitbvh_tpu.parallel import (make_mesh, sharded_rays,
                                      sharded_rebuild_traverse_step,
                                      sharded_self_contact,
                                      sharded_tile_self_contact)


def spheres(n, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 3), dtype=np.float32) * scale
    rs = (rng.random(n, dtype=np.float32) * 0.4 + 0.05).astype(np.float32)
    return xs, rs, ib.BSphere(jnp.asarray(xs), jnp.asarray(rs))


def brute_force(xs, rs):
    n = len(rs)
    d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    rr = (rs[:, None] + rs[None, :]) ** 2
    return {(i + 1, j + 1) for i in range(n) for j in range(i + 1, n)
            if d2[i, j] <= rr[i, j]}


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(jax.devices()[:8])


def test_sharded_self_contact_matches_single(mesh):
    xs, rs, sp = spheres(128, 42)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    total, out, counts, overflow = sharded_self_contact(
        mesh, bvh, capacity_per_device=256)
    assert int(total) == len(bf)
    assert int(jnp.sum(counts)) == len(bf)
    assert not bool(overflow)
    got = {tuple(map(int, r)) for r in np.asarray(out) if tuple(r) != (0, 0)}
    assert got == bf


def test_sharded_tile_self_contact_matches_single(mesh):
    """The multi-device tile path: superpairs dealt over the mesh, the
    whole tile pipeline per device; contact set identical to brute force."""
    from implicitbvh_tpu.traverse import TileTraversal
    xs, rs, sp = spheres(300, 7)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    total, out, counts, overflow = sharded_tile_self_contact(
        mesh, bvh, capacity_per_device=256, alg=TileTraversal(tile=32))
    assert not bool(overflow)
    assert int(total) == len(bf)
    assert int(jnp.sum(counts)) == len(bf)
    got = set()
    cpd = 256
    arr = np.asarray(out)
    cnts = np.asarray(counts)
    for d in range(cnts.shape[0]):
        for r in arr[d * cpd:d * cpd + int(cnts[d])]:
            got.add(tuple(map(int, r)))
    assert got == bf


def test_sharded_tile_phase1_spreads_across_devices(mesh):
    """Phase 1 is per-device (superpairs dealt round-robin), so a scene
    with several live supertile pairs must produce contacts on more than
    one device."""
    from implicitbvh_tpu.traverse import TileTraversal
    xs, rs, sp = spheres(2048, 11, scale=16.0)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    total, out, counts, overflow = sharded_tile_self_contact(
        mesh, bvh, capacity_per_device=2048,
        alg=TileTraversal(tile=32))
    assert not bool(overflow)
    assert int(total) == len(bf)
    cnts = np.asarray(counts)
    assert (cnts > 0).sum() >= 2, cnts
    got = set()
    arr = np.asarray(out)
    for d in range(cnts.shape[0]):
        for r in arr[d * 2048:d * 2048 + int(cnts[d])]:
            got.add(tuple(map(int, r)))
    assert got == bf


@pytest.mark.parametrize("engine", ["tiles", "walk"])
def test_sharded_rays_matches_single(mesh, engine):
    """Both ray engines: the per-device ray-tile pipeline (coherence sort
    + count/emit passes per ray slice) and the stackless walk."""
    rng = np.random.default_rng(1)
    xs, rs, sp = spheres(64, 2)
    p = (rng.random((3, 16)).astype(np.float32) * 8 - 1.5)
    d = (rng.random((3, 16)).astype(np.float32) - 0.5)
    bvh = ib.build(sp, ib.BBox)
    ref = set(ib.traverse_rays(bvh, p, d).contacts_list())
    total, out, counts, overflow = sharded_rays(
        mesh, bvh, p, d, capacity_per_device=128, engine=engine)
    assert int(total) == len(ref)
    assert int(jnp.sum(counts)) == len(ref)
    assert not bool(overflow)
    got = {tuple(map(int, r)) for r in np.asarray(out) if tuple(r) != (0, 0)}
    assert got == ref


def test_sharded_full_step(mesh):
    from implicitbvh_tpu.traverse import TileTraversal
    xs, rs, sp = spheres(128, 3)
    bf = brute_force(xs, rs)
    step = sharded_rebuild_traverse_step(
        mesh, capacity_per_device=256,
        alg=TileTraversal(tile=32))
    total, out, counts, overflow = step(sp.x, sp.r)
    assert int(total) == len(bf)
    assert not bool(overflow)
    # move geometry and step again (recompile-free fixed shapes)
    xs2 = xs + 0.1
    total2, _, _, _ = step(jnp.asarray(xs2), sp.r)
    bf2 = brute_force(xs2, rs)
    assert int(total2) == len(bf2)


def test_sharded_tile_pair_matches_single(mesh):
    """Two-BVH pair traversal sharded over the mesh (superpairs dealt to
    devices): cross-device contact set equals brute force and the
    single-device tile engine's."""
    from implicitbvh_tpu.parallel import sharded_tile_pair
    from implicitbvh_tpu.traverse import TileTraversal, traverse_tiles_pair
    xs1, rs1, sp1 = spheres(300, 21)
    xs2, rs2, sp2 = spheres(200, 22)
    bvh1 = ib.build(sp1, ib.BBox)
    bvh2 = ib.build(sp2, ib.BBox)
    # brute force: full grid, tree order (i in bvh1, j in bvh2)
    d2 = ((xs1[:, None, :] - xs2[None, :, :]) ** 2).sum(-1)
    rr = (rs1[:, None] + rs2[None, :]) ** 2
    bf = {(i + 1, j + 1) for i in range(300) for j in range(200)
          if d2[i, j] <= rr[i, j]}
    alg = TileTraversal(tile=32)
    single = traverse_tiles_pair(bvh1, bvh2, alg=alg)
    assert set(single.contacts_list()) == bf
    total, out, counts, overflow = sharded_tile_pair(
        mesh, bvh1, bvh2, capacity_per_device=512, alg=alg)
    assert not bool(overflow)
    assert int(total) == len(bf)
    assert int(jnp.sum(counts)) == len(bf)
    got = set()
    cpd = 512
    arr = np.asarray(out)
    cnts = np.asarray(counts)
    for d in range(cnts.shape[0]):
        for r in arr[d * cpd:d * cpd + int(cnts[d])]:
            got.add(tuple(map(int, r)))
    assert got == bf


@pytest.mark.skipif(not __import__("os").environ.get("IBVH_SLOW"),
                    reason="at-scale mesh test: set IBVH_SLOW=1")
def test_sharded_tile_self_contact_at_scale(mesh):
    """>= 32k leaves on the 8-device mesh (VERDICT r4 #8): exercises the
    per-device S_loc/E2_cap sizing and the round-robin superpair density
    balancing that tiny scenes cannot — parity vs the single-device tile
    engine, and NO overflow."""
    from implicitbvh_tpu.traverse import TileTraversal, traverse_tiles
    n = 1 << 15
    xs, rs, sp = spheres(n, 33, scale=float(n) ** (1.0 / 3.0))
    bvh = ib.build(sp, ib.BBox)
    alg = TileTraversal()
    single = traverse_tiles(bvh, alg=alg)
    ref = set(single.contacts_list())
    total, out, counts, overflow = sharded_tile_self_contact(
        mesh, bvh, capacity_per_device=4096, alg=alg)
    assert not bool(overflow)
    assert int(total) == len(ref)
    got = set()
    cpd = 4096
    arr = np.asarray(out)
    cnts = np.asarray(counts)
    assert (cnts > 0).sum() >= 4, cnts   # work actually spreads
    for d in range(cnts.shape[0]):
        for r in arr[d * cpd:d * cpd + int(cnts[d])]:
            got.add(tuple(map(int, r)))
    assert got == ref


def test_sharded_divisibility_error(mesh):
    xs, rs, sp = spheres(100, 4)  # 100 % 8 != 0
    bvh = ib.build(sp, ib.BBox)
    with pytest.raises(ValueError):
        sharded_self_contact(mesh, bvh, capacity_per_device=64)
