"""Multi-device scaling over a ``jax.sharding.Mesh``.

The reference is a single-device library (SURVEY.md §2.2: no distributed
backend); this module is an *extension*: scale collision detection and ray
tracing across devices by sharding the embarrassingly-parallel work (query
lanes for the walk, superpairs or ray slices for the tile engine) while
replicating the (small) tree or leaf tiles, with ``shard_map`` + ``psum``
for the contact totals.

Design:

- **Build** runs under ``jit`` with input shardings; the Morton sort is the
  only genuinely global step (XLA gathers for it), everything else —
  bounding-volume construction, Morton encoding, per-level aggregation — is
  elementwise/reduction work that XLA shards freely.
- **Traversal** shards lanes: each device runs the stackless walk for its
  slice of leaves/rays against the replicated tree, writing contacts into
  its own capacity slice.  Totals cross devices as one ``psum``; contact
  buffers stay device-local (shape ``(n_dev * cap_per_dev, 2)`` overall).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..build import BVH, Leaves, build
from ..traverse.walk import stackless_walk
from ..volumes import BBox, BSphere, convert_volume, iscontact, isintersection

AXIS = "data"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """1D device mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (axis,))


def _local_self_contact(bvh: BVH, local_leaves: Leaves, lane_offset,
                       start_level: int, capacity: int, narrow=None):
    """Walk the replicated tree for a local slice of query leaves.

    ``lane_offset`` is this device's global lane start (0-based); the dedup
    rule needs *global* sorted-leaf positions.
    """
    k = local_leaves.index.shape[0]
    idt = bvh.skips.dtype
    q_node_vol = convert_volume(bvh.node_kind, local_leaves.volume)

    def node_test(node_vol):
        return iscontact(q_node_vol, node_vol)

    def leaf_test(leaf):
        hit = iscontact(local_leaves.volume, leaf.volume)
        if narrow is not None:
            hit = hit & narrow(local_leaves, leaf)
        return hit

    def emit(leaf):
        a = jnp.minimum(local_leaves.index, leaf.index)
        b = jnp.maximum(local_leaves.index, leaf.index)
        return jnp.stack([a, b], axis=-1)

    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    dedup = (lane_offset + jnp.arange(1, k + 1, dtype=idt)) + leaf_base

    counts, _ = stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        node_test, leaf_test, emit, num_lanes=k, dedup_ileaf=dedup)
    offsets = jnp.cumsum(counts) - counts
    _, out = stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        node_test, leaf_test, emit, num_lanes=k, dedup_ileaf=dedup,
        capacity=capacity, offsets=offsets)
    return counts.sum(), out


def sharded_self_contact(mesh: Mesh, bvh: BVH, capacity_per_device: int,
                         start_level: Optional[int] = None, narrow=None,
                         axis: str = AXIS):
    """Self-contact traversal with leaves sharded over ``mesh``.

    Returns ``(total, contacts, counts, overflow)`` where ``contacts`` is
    ``(n_dev * capacity_per_device, 2)`` with each device's valid prefix in
    its slice, ``total`` is the global contact count (psum over devices),
    ``counts`` is the per-device valid-prefix length ``(n_dev,)``, and
    ``overflow`` signals that some device produced more contacts than
    ``capacity_per_device`` (its slice is truncated) — mirroring the
    single-device fixed-capacity API contract.

    Requires the leaf count to be divisible by the mesh size (pad upstream
    if needed).
    """
    if start_level is None:
        start_level = max(1, bvh.built_level)
    n_dev = mesh.shape[axis]
    n = bvh.num_leaves
    if n % n_dev != 0:
        raise ValueError(f"num_leaves {n} not divisible by mesh size {n_dev}")
    per_dev = n // n_dev

    def local_fn(bvh_rep, local_leaves):
        lane_offset = jax.lax.axis_index(axis).astype(bvh_rep.skips.dtype) \
            * per_dev
        total, out = _local_self_contact(
            bvh_rep, local_leaves, lane_offset, start_level,
            capacity_per_device, narrow)
        overflow = jax.lax.psum(
            (total > capacity_per_device).astype(jnp.int32), axis) > 0
        return (jax.lax.psum(total, axis), out, total.reshape(1), overflow)

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(), P(axis), P(axis), P()),
        check_vma=False,
    )
    leaves_sharded = jax.tree_util.tree_map(lambda a: a, bvh.leaves)
    return fn(bvh, leaves_sharded)


def sharded_rays(mesh: Mesh, bvh: BVH, points, directions,
                 capacity_per_device: int, start_level: int = 1,
                 narrow=None, axis: str = AXIS, engine: str = "tiles",
                 alg=None, pair_capacity: Optional[int] = None):
    """Ray traversal with rays sharded over ``mesh``; (3, N) ray matrices.

    ``engine="tiles"`` (default) runs the dense ray-tile engine per device:
    each device coherence-sorts its own ray slice and runs the whole tile
    pipeline against the replicated leaf tiles — rays are embarrassingly
    parallel, so phase 1 included scales with mesh size.
    ``engine="walk"`` runs the stackless LVT walk per device instead.
    ``pair_capacity`` is each device's candidate-entry capacity for the
    tile engine; by default twice the single-device estimate for its ray
    slice, since a slice of rays is less coherent than the whole set.

    Returns ``(total, contacts, counts, overflow)`` like
    :func:`sharded_self_contact`; ray indices in contacts are *global*
    1-based.
    """
    n_dev = mesh.shape[axis]
    nrays = points.shape[1]
    if nrays % n_dev != 0:
        raise ValueError(f"num rays {nrays} not divisible by mesh {n_dev}")
    per_dev = nrays // n_dev
    pts = jnp.asarray(points, bvh.leaves.volume.dtype)
    dirs = jnp.asarray(directions, bvh.leaves.volume.dtype)
    p_l = (pts[0], pts[1], pts[2])   # coordinate tuples of (N,) lanes
    d_l = (dirs[0], dirs[1], dirs[2])

    if engine == "tiles":
        from ..traverse.ray_tiles import (_ray_pair_capacity,
                                          traverse_rays_tiles_fixed)
        from ..traverse.tiles import TileTraversal
        alg = alg or TileTraversal()
        if pair_capacity is None:
            pair_capacity = 2 * _ray_pair_capacity(
                -(-per_dev // alg.tile), alg.bands)

        def local_tiles(bvh_rep, p, d):
            dev = jax.lax.axis_index(axis)
            total, contacts, ov, _nc = traverse_rays_tiles_fixed(
                bvh_rep, jnp.stack(p), jnp.stack(d), capacity_per_device,
                alg=alg, pair_capacity=pair_capacity, narrow=narrow)
            # globalize the 1-based ray indices (column 1; pad rows are 0)
            off = (dev * per_dev).astype(contacts.dtype)
            col = contacts[:, 1]
            contacts = contacts.at[:, 1].set(jnp.where(col > 0, col + off, 0))
            overflow = jax.lax.psum((ov > 0).astype(jnp.int32), axis) > 0
            return (jax.lax.psum(total, axis), contacts,
                    total.reshape(1).astype(jnp.int32), overflow)

        fn = shard_map(
            local_tiles, mesh=mesh,
            in_specs=(P(), P(axis), P(axis)),
            out_specs=(P(), P(axis), P(axis), P()),
            check_vma=False,
        )
        return fn(bvh, p_l, d_l)

    def local_fn(bvh_rep, p, d):
        idt = bvh_rep.skips.dtype
        k = p[0].shape[0]
        ray_offset = jax.lax.axis_index(axis).astype(idt) * per_dev
        iray = ray_offset + jnp.arange(1, k + 1, dtype=idt)

        def node_test(node_vol):
            return isintersection(node_vol, p, d)

        def leaf_test(leaf):
            hit = isintersection(leaf.volume, p, d)
            if narrow is not None:
                hit = hit & narrow(leaf, p, d)
            return hit

        def emit(leaf):
            return jnp.stack([leaf.index, iray], axis=-1)

        counts, _ = stackless_walk(
            bvh_rep.tree, bvh_rep.nodes, bvh_rep.leaves, bvh_rep.skips,
            start_level, node_test, leaf_test, emit, num_lanes=k)
        offsets = jnp.cumsum(counts) - counts
        _, out = stackless_walk(
            bvh_rep.tree, bvh_rep.nodes, bvh_rep.leaves, bvh_rep.skips,
            start_level, node_test, leaf_test, emit, num_lanes=k,
            capacity=capacity_per_device, offsets=offsets)
        total = counts.sum()
        overflow = jax.lax.psum(
            (total > capacity_per_device).astype(jnp.int32), axis) > 0
        return (jax.lax.psum(total, axis), out, total.reshape(1), overflow)

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P(axis), P(axis), P()),
        check_vma=False,
    )
    return fn(bvh, p_l, d_l)


def sharded_tile_self_contact(mesh: Mesh, bvh: BVH,
                              capacity_per_device: int, *,
                              alg=None, narrow=None, axis: str = AXIS):
    """Self-contact on the dense-tile engine with phase 1 and both passes
    sharded over the mesh (the walk-based :func:`sharded_self_contact`
    stays as the reference-shaped alternative).

    Only level A (the dense S x S supertile overlap and its compaction)
    runs replicated; the *superpair list* it produces is dealt to the
    devices, and each device runs the rest of the pipeline on its share:
    band bits, entry compaction, count pass, emit pass and contact
    mapping, all against the replicated leaf tiles.  A (ti, tj) tile pair
    lives in exactly one superpair, so per-device contact sets are
    disjoint and only scalar totals cross devices (one psum).

    Returns ``(total, contacts, counts, overflow)`` exactly like
    :func:`sharded_self_contact`: ``contacts`` is
    ``(n_dev * capacity_per_device, 2)`` with each device's valid prefix
    in its slice.
    """
    from ..traverse.tiles import (TileTraversal, _phase1_superpairs,
                                  _tiled_fields)

    alg = alg or TileTraversal()
    n_dev = mesh.shape[axis]
    fields, sphere, tile_lo, tile_up, sub_lo, sub_up, T = \
        _tiled_fields(bvh, alg.tile, alg.bands)
    P_loc = _local_pair_capacity(T, alg.bands, n_dev)
    si, sj, nsp, p1_over = _phase1_superpairs(
        tile_lo, tile_up, P_loc * n_dev, sp_round=16 * n_dev)
    si, sj = _deal(si, n_dev), _deal(sj, n_dev)

    def local_fn(fields_rep, leaves_rep, tl_rep, tu_rep, sl_rep, su_rep,
                 nsp_rep, si_loc, sj_loc):
        return _local_tile_contacts(
            fields_rep, fields_rep, leaves_rep, leaves_rep, sl_rep, su_rep,
            tl_rep, tu_rep, nsp_rep, si_loc, sj_loc, T, T, sphere, alg,
            P_loc, capacity_per_device, narrow, axis, self_contact=True)

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(),) * 7 + (P(axis), P(axis)),
        out_specs=(P(), P(axis), P(axis), P()),
        check_vma=False,
    )
    total, contacts, counts, overflow = fn(
        fields, bvh.leaves, tile_lo, tile_up, sub_lo, sub_up, nsp, si, sj)
    return total, contacts, counts, overflow | p1_over


def sharded_tile_pair(mesh: Mesh, bvh1: BVH, bvh2: BVH,
                      capacity_per_device: int, *,
                      alg=None, narrow=None, axis: str = AXIS):
    """Two-BVH tile traversal sharded over the mesh — the multi-device
    counterpart of traverse.tiles.traverse_tiles_pair_fixed, built like
    :func:`sharded_tile_self_contact`: the replicated level-A pass
    extracts overlapping (supertile-of-bvh1, supertile-of-bvh2) pairs from
    the full S1 x S2 grid (no triangle — the reference's pair-traversal
    semantics, ref traverse_pair_cpu.jl:615-645), the superpair list is
    dealt to the devices, and each device runs band bits -> entries ->
    count -> emit -> contact mapping on its share.

    Returns ``(total, contacts, counts, overflow)``; ``contacts`` holds
    tree-order (index-in-bvh1, index-in-bvh2) rows per device slice.
    """
    from ..traverse.tiles import (TileTraversal, _phase1_cross_superpairs,
                                  _tiled_fields)

    alg = alg or TileTraversal()
    if bvh1.leaf_kind is not bvh2.leaf_kind:
        raise NotImplementedError(
            "tile pair traversal requires matching leaf volume kinds")
    n_dev = mesh.shape[axis]
    f1, sphere, tlo1, tup1, asub_lo, asub_up, T1 = \
        _tiled_fields(bvh1, alg.tile, alg.bands)
    f2, _, tlo2, tup2, _, _, T2 = _tiled_fields(bvh2, alg.tile)
    P_loc = _local_pair_capacity((T1 + T2) // 2, alg.bands, n_dev)
    si, sj, nsp, p1_over = _phase1_cross_superpairs(
        tlo1, tup1, tlo2, tup2, P_loc * n_dev, sp_round=16 * n_dev)
    si, sj = _deal(si, n_dev), _deal(sj, n_dev)

    def local_fn(f1_rep, f2_rep, l1_rep, l2_rep, tlo2_rep, tup2_rep,
                 sl_rep, su_rep, nsp_rep, si_loc, sj_loc):
        return _local_tile_contacts(
            f1_rep, f2_rep, l1_rep, l2_rep, sl_rep, su_rep, tlo2_rep,
            tup2_rep, nsp_rep, si_loc, sj_loc, T1, T2, sphere, alg, P_loc,
            capacity_per_device, narrow, axis, self_contact=False)

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(),) * 9 + (P(axis), P(axis)),
        out_specs=(P(), P(axis), P(axis), P()),
        check_vma=False,
    )
    total, contacts, counts, overflow = fn(
        f1, f2, bvh1.leaves, bvh2.leaves, tlo2, tup2, asub_lo, asub_up, nsp,
        si, sj)
    return total, contacts, counts, overflow | p1_over


def _local_pair_capacity(num_tiles: int, bands: int, n_dev: int) -> int:
    """Per-device entry capacity: an even share of the single-device
    capacity (superpairs are dealt round-robin, which balances density)."""
    from ..traverse.tiles import _pair_capacity_for
    share = -(-_pair_capacity_for(num_tiles, bands) // n_dev)
    return -(-share // 1024) * 1024


def _deal(a, n_dev: int):
    """Deal a compacted list ROUND-ROBIN to devices (device d takes
    entries d, d + n_dev, ...), laid out device-major for ``P(axis)``.
    The superpair list is ordered row-major, so contiguous slices would
    pile the dense diagonal-region superpairs onto the low devices;
    striping balances them and still keeps each device's valid entries a
    prefix (global index k * n_dev + d < nsp  <=>  k < ceil((nsp-d)/n))."""
    return a.reshape(-1, n_dev).T.reshape(-1)


def _local_tile_contacts(fa, fb, leaves_a, leaves_b, sub_lo, sub_up,
                         tlo_b, tup_b, nsp, si_loc, sj_loc, Ta: int,
                         Tb: int, sphere: bool, alg, P_loc: int,
                         cap_dev: int, narrow, axis: str,
                         self_contact: bool):
    """One device's share of the sharded tile engine: its superpairs ->
    band bits -> entries -> contacts, with psum'd totals and overflow."""
    from ..ops.subtile import subtile_band_bits
    from ..traverse.tiles import (_band_contacts, _entries_from_bits,
                                  _finish_contacts, _leaf_narrow)

    n_dev = jax.lax.psum(1, axis)
    dev = jax.lax.axis_index(axis)
    NB = alg.bands
    nsp_loc = jnp.clip((nsp - dev + n_dev - 1) // n_dev, 0,
                       si_loc.shape[0])
    bits = subtile_band_bits(sub_lo, sub_up, tlo_b, tup_b, si_loc, sj_loc,
                             nsp_loc, Ta=Ta, Tb=Tb, triangle=self_contact,
                             n_bands=NB)
    ea, eb, ne = _entries_from_bits(bits, si_loc, sj_loc, NB, P_loc)
    mask_kind = "sphere" if sphere else "box"
    gi, gj, raw = _band_contacts(fa, fb, ea, eb, ne, mask_kind, NB,
                                 dedup=self_contact, capacity=cap_dev)
    total, contacts = _finish_contacts(
        gi, gj, raw, leaves_a.index, _leaf_narrow(narrow, leaves_a, leaves_b),
        cap_dev, leaf_index_b=leaves_b.index, sort_pairs=self_contact)
    over = (raw > cap_dev) | (ne > P_loc)
    overflow = jax.lax.psum(over.astype(jnp.int32), axis) > 0
    return (jax.lax.psum(total, axis), contacts, total.reshape(1),
            overflow)


def sharded_rebuild_traverse_step(mesh: Mesh, node_kind=BBox,
                                  capacity_per_device: int = 1 << 16,
                                  axis: str = AXIS, engine: str = "tiles",
                                  alg=None):
    """The full moving-geometry step on several devices: rebuild the BVH
    from updated leaf spheres and run sharded self-contact — the
    counterpart of the reference's cache-reusing per-step rebuild loop
    (BASELINE config 5).

    ``engine``: "tiles" (the dense-tile engine; ``alg`` is its
    TileTraversal; this fixed-shape path has no growth loop, so the
    overflow flag reports a capacity the scene exceeded) or "walk" (the
    stackless LVT walk per leaf slice).

    Returns a jittable ``step(x, r) -> (total, contacts, counts, overflow)``.
    """

    @jax.jit
    def step(x, r):
        bvh = build(BSphere(x, r), node_kind)
        if engine == "tiles":
            return sharded_tile_self_contact(mesh, bvh, capacity_per_device,
                                             alg=alg, axis=axis)
        return sharded_self_contact(mesh, bvh, capacity_per_device, axis=axis)

    return step
