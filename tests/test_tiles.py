"""Tile traversal tests: differential vs brute force and vs LVT;
growth-loop coverage."""

import numpy as np
import jax.numpy as jnp
import pytest

import implicitbvh_tpu as ib
from implicitbvh_tpu.traverse import TileTraversal, traverse, traverse_tiles


def spheres(n, seed, scale=None):
    rng = np.random.default_rng(seed)
    if scale is None:
        scale = 5.0
    xs = (rng.random((n, 3)) * scale).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    return xs, rs, ib.BSphere(jnp.asarray(xs), jnp.asarray(rs))


def brute_force(xs, rs):
    n = len(rs)
    d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    rr = (rs[:, None] + rs[None, :]) ** 2
    return {(i + 1, j + 1) for i in range(n) for j in range(i + 1, n)
            if d2[i, j] <= rr[i, j]}


def test_tiles_differential_sphere_leaves():
    xs, rs, sp = spheres(300, 42)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    t = traverse_tiles(bvh, alg=TileTraversal(tile=32))
    assert set(t.contacts_list()) == bf
    # the tile engine reports its executed leaf-test count (live bands x
    # band size): at least one test per contact, at most the dense total
    assert int(t.num_checks) >= len(bf)
    assert int(t.num_checks) <= 300 * 300


def test_tiles_via_traverse_dispatch():
    xs, rs, sp = spheres(200, 1)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    t = traverse(bvh, TileTraversal(tile=32))
    assert set(t.contacts_list()) == bf


def test_tiles_box_leaves():
    xs, rs, _ = spheres(150, 3)
    lo, up = xs - rs[:, None], xs + rs[:, None]
    n = len(rs)
    bf = {(i + 1, j + 1) for i in range(n) for j in range(i + 1, n)
          if ((up[i] >= lo[j]) & (lo[i] <= up[j])).all()}
    boxes = ib.BBox(jnp.asarray(lo), jnp.asarray(up))
    bvh = ib.build(boxes, ib.BBox)
    t = traverse_tiles(bvh, alg=TileTraversal(tile=32))
    assert set(t.contacts_list()) == bf


def test_tiles_matches_lvt():
    xs, rs, sp = spheres(257, 7)
    bvh = ib.build(sp, ib.BBox)
    t_tile = traverse_tiles(bvh, alg=TileTraversal(tile=32))
    t_lvt = traverse(bvh)
    assert sorted(t_tile.contacts_list()) == sorted(t_lvt.contacts_list())


def test_tiles_narrow_predicate():
    xs, rs, sp = spheres(120, 9)
    bf = brute_force(xs, rs)
    bf_n = {(i, j) for (i, j) in bf if (i + j) % 3 != 0}

    def narrow(l1, l2):
        return (l1.index + l2.index) % 3 != 0

    bvh = ib.build(sp, ib.BBox)
    t = traverse_tiles(bvh, alg=TileTraversal(tile=32), narrow=narrow)
    assert set(t.contacts_list()) == bf_n


def test_tiles_overflow_growth():
    # dense cluster with tiny starting capacities: both the contact buffer
    # and the candidate entry list overflow and must grow to the exact set
    from implicitbvh_tpu.traverse.types import BVHTraversal
    xs, rs, sp = spheres(96, 5, scale=0.8)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    tiny = BVHTraversal(num_contacts=0, cache1=jnp.zeros((64, 2), jnp.int32),
                        cache2=jnp.zeros((0,), jnp.int32), pair_capacity=8)
    t = traverse_tiles(bvh, alg=TileTraversal(tile=32), cache=tiny)
    assert set(t.contacts_list()) == bf
    assert t.cache1.shape[0] >= len(bf) > 64
    assert t.pair_capacity > 8


def test_tiles_stream_output_path():
    """The fixed-capacity program's dense contact stream must match brute
    force exactly, including with a narrow filter."""
    from implicitbvh_tpu.traverse.tiles import traverse_tiles_fixed
    xs, rs, sp = spheres(300, 11)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    alg = TileTraversal(tile=32)
    total, contacts, ov, _nc = traverse_tiles_fixed(bvh, 1024, alg=alg)
    assert int(ov) == 0
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    assert got == bf

    def narrow(l1, l2):
        return (l1.index + l2.index) % 2 == 0

    bf_n = {(i, j) for (i, j) in bf if (i + j) % 2 == 0}
    total2, contacts2, ov2, _ = traverse_tiles_fixed(
        bvh, 1024, alg=alg, narrow=narrow)
    assert int(ov2) == 0
    got2 = {tuple(map(int, r)) for r in np.asarray(contacts2)[:int(total2)]}
    assert got2 == bf_n


def test_tiles_single_and_tiny():
    one = ib.build(ib.BSphere(jnp.zeros((1, 3)), jnp.ones((1,))), ib.BBox)
    assert traverse_tiles(one).contacts_list() == []
    xs = np.array([[0, 0, 0], [0, 0, 1.0]], np.float32)
    rs = np.array([0.6, 0.6], np.float32)
    two = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    t = traverse_tiles(two, alg=TileTraversal(tile=32))
    assert t.contacts_list() == [(1, 2)]


def test_tiles_pair_differential():
    xs1, rs1, sp1 = spheres(150, 31)
    xs2, rs2, sp2 = spheres(90, 32)
    d2 = ((xs1[:, None, :] - xs2[None, :, :]) ** 2).sum(-1)
    rr = (rs1[:, None] + rs2[None, :]) ** 2
    bf = {(i + 1, j + 1) for i in range(150) for j in range(90)
          if d2[i, j] <= rr[i, j]}
    b1 = ib.build(sp1, ib.BBox)
    b2 = ib.build(sp2, ib.BBox)
    t = traverse(b1, b2, TileTraversal(tile=32))
    assert set(t.contacts_list()) == bf
    # matches the LVT pair path exactly
    t_lvt = traverse(b1, b2)
    assert sorted(t.contacts_list()) == sorted(t_lvt.contacts_list())


def test_tiles_two_phase_r16():
    """A 16-leaf tile (bands of 4 leaves) must match brute force exactly
    through the count and emit passes."""
    from implicitbvh_tpu.traverse.tiles import traverse_tiles_fixed
    xs, rs, sp = spheres(300, 11)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    alg = TileTraversal(tile=16)
    total, contacts, ov, _nc = traverse_tiles_fixed(bvh, 1024, alg=alg)
    assert int(ov) == 0
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    assert got == bf


def test_tiles_two_phase_count_w16(monkeypatch):
    """A count-pass chunk of 16 entries (many loop steps, a partial last
    chunk) must match brute force exactly."""
    from implicitbvh_tpu.traverse import tiles
    monkeypatch.setattr(tiles, "ENTRY_CHUNK", 16)
    xs, rs, sp = spheres(300, 12)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    alg = TileTraversal(tile=32)
    # a capacity no other test compiles, so the patched chunk is traced
    total, contacts, ov, _nc = tiles.traverse_tiles_fixed(bvh, 1016,
                                                          alg=alg)
    assert int(ov) == 0
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    assert got == bf


def test_tiles_pair_two_phase_path():
    """The fixed-capacity two-BVH program (count pass -> emit stream) must
    match brute force exactly, including the narrow filter."""
    from implicitbvh_tpu.traverse.tiles import traverse_tiles_pair_fixed
    xs1, rs1, sp1 = spheres(150, 41)
    xs2, rs2, sp2 = spheres(90, 42)
    d2 = ((xs1[:, None, :] - xs2[None, :, :]) ** 2).sum(-1)
    rr = (rs1[:, None] + rs2[None, :]) ** 2
    bf = {(i + 1, j + 1) for i in range(150) for j in range(90)
          if d2[i, j] <= rr[i, j]}
    b1 = ib.build(sp1, ib.BBox)
    b2 = ib.build(sp2, ib.BBox)
    alg = TileTraversal(tile=32)
    total, contacts, ov, _nc = traverse_tiles_pair_fixed(b1, b2, 1024,
                                                         alg=alg)
    assert int(ov) == 0
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    assert got == bf

    def narrow(l1, l2):
        return (l1.index + l2.index) % 2 == 0

    bf_n = {(i, j) for (i, j) in bf if (i + j) % 2 == 0}
    total2, contacts2, ov2, _ = traverse_tiles_pair_fixed(
        b1, b2, 1024, alg=alg, narrow=narrow)
    assert int(ov2) == 0
    got2 = {tuple(map(int, r)) for r in np.asarray(contacts2)[:int(total2)]}
    assert got2 == bf_n


def test_tiles_pair_narrow():
    xs1, rs1, sp1 = spheres(60, 33)
    xs2, rs2, sp2 = spheres(70, 34)

    def narrow(l1, l2):
        return (l1.index * 3 + l2.index) % 4 != 0

    b1 = ib.build(sp1, ib.BBox)
    b2 = ib.build(sp2, ib.BBox)
    t = traverse(b1, b2, TileTraversal(tile=32), narrow=narrow)
    t_lvt = traverse(b1, b2, narrow=narrow)
    assert sorted(t.contacts_list()) == sorted(t_lvt.contacts_list())


def test_tiles_fine_bands_self_and_pair():
    """bands=8/16 (finer phase-1b sub-bands; ops/subtile.py) must not
    change any contact set — band boxes cover all leaves, so finer bands
    only shrink the tested superset."""
    from implicitbvh_tpu.traverse.tiles import (traverse_tiles_fixed,
                                                traverse_tiles_pair_fixed)
    xs, rs, sp = spheres(300, 12)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    checks = {}
    for nb in (8, 16):
        alg = TileTraversal(tile=32, bands=nb)
        total, contacts, ov, nc = traverse_tiles_fixed(bvh, 1024, alg=alg)
        assert int(ov) == 0
        got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
        assert got == bf, nb
        checks[nb] = int(nc)
    # finer bands must never test MORE candidates
    assert checks[16] <= checks[8]

    xs2, rs2, sp2 = spheres(90, 13)
    d2 = ((xs[:, None, :] - xs2[None, :, :]) ** 2).sum(-1)
    rr = (rs[:, None] + rs2[None, :]) ** 2
    bf2 = {(i + 1, j + 1) for i in range(300) for j in range(90)
           if d2[i, j] <= rr[i, j]}
    b2 = ib.build(sp2, ib.BBox)
    alg = TileTraversal(tile=32, bands=16)
    total, contacts, ov, _nc = traverse_tiles_pair_fixed(bvh, b2, 1024,
                                                         alg=alg)
    assert int(ov) == 0
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    assert got == bf2


def test_tiles_moment_decode_route():
    """A dense scene (rows with many contacts, whole tile pairs in
    contact) must emit exactly the brute-force set, with coarse and fine
    bands alike."""
    xs, rs, sp = spheres(700, 21, scale=3.0)
    bf = brute_force(xs, rs)
    bvh = ib.build(sp, ib.BBox)
    t4 = traverse_tiles(bvh, alg=TileTraversal(tile=32))
    assert set(t4.contacts_list()) == bf
    t16 = traverse_tiles(bvh, alg=TileTraversal(tile=32, bands=16))
    assert sorted(t16.contacts_list()) == sorted(t4.contacts_list())
    assert t16.num_checks <= t4.num_checks


def test_tiles_moment_decode_narrow():
    """The narrow predicate applies after the emit pass, also to rows
    holding many contacts."""
    xs, rs, sp = spheres(150, 23, scale=2.0)
    bf = brute_force(xs, rs)
    bf_n = {(i, j) for (i, j) in bf if (i + j) % 2 == 0}

    def narrow(l1, l2):
        return (l1.index + l2.index) % 2 == 0

    bvh = ib.build(sp, ib.BBox)
    t = traverse_tiles(bvh, alg=TileTraversal(tile=32), narrow=narrow)
    assert set(t.contacts_list()) == bf_n
