"""Dense tile engine for ray traversal.

The same scheme as tile self-contact (traverse/tiles.py), with rays on the
a side:

1. Rays are sorted for coherence by (direction bin, Morton code of origin)
   — direction bin = octant + dominant axis — and grouped into ray tiles
   of ``G``, each split into ``bands`` ray bands.
2. Phase 1: a dense slab test of every ray against every leaf-tile AABB,
   any-reduced over each ray band, yields the live (ray band, leaf tile)
   entries, compacted with cumsum + scatter.
3. Phase 2 (ops/tile_contact.py): the count pass tests each entry's
   (rays, leaves) block with the exact ``isintersection`` predicate and
   the emit pass streams the hits.
4. Sorted positions map back to (leaf_user_index, iray) pairs (1-based ray
   indices) — the reference's ray contact convention
   (ref src/raytrace/raytrace.jl:88-100).

Contact sets equal the reference's LVT ray traversal
(ref src/raytrace/leaf_vs_tree/leaf_vs_tree.jl:170-228): the tile pass
tests a superset of the tree-pruned candidates with the same predicates.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..build import BVH
from ..morton import DefaultMortonAlgorithm, morton_encode
from ..options import DEFAULT_OPTIONS, BVHOptions
from .tiles import (RAY_ENTRIES_PER_RAY_TILE, TileTraversal, _band_contacts,
                    _compact_flat, _finish_contacts, _grow_loop,
                    _initial_capacity, _live_bands, _overflow_bits,
                    _tiled_fields)
from .types import BVHTraversal


def _sort_rays(p, d):
    """Coherence sort: permutation ordering rays by (direction bin, Morton
    code of origin).  Direction bin = sign octant (3 bits) x dominant axis
    (0..2); origins are Morton-encoded u32."""
    n = p[0].shape[0]
    octant = ((d[0] < 0).astype(jnp.uint32) * 4 +
              (d[1] < 0).astype(jnp.uint32) * 2 +
              (d[2] < 0).astype(jnp.uint32))
    a0, a1, a2 = jnp.abs(d[0]), jnp.abs(d[1]), jnp.abs(d[2])
    ax = jnp.where(a0 >= a1,
                   jnp.where(a0 >= a2, 0, 2),
                   jnp.where(a1 >= a2, 1, 2)).astype(jnp.uint32)
    dbin = octant * 3 + ax
    code = morton_encode(p, DefaultMortonAlgorithm(bits=32))
    idx = jnp.arange(n, dtype=jnp.int32)
    _, _, perm = jax.lax.sort((dbin, code, idx), num_keys=2)
    return perm


def _ray_tile_fields(p, d, perm, G: int):
    """Permute rays and tile into (RT, G) fields (p0, p1, p2, d0, d1, d2)."""
    n = p[0].shape[0]
    RT = -(-n // G)
    pad = RT * G - n

    def padded(a, fill):
        a = a[perm]
        if pad:
            a = jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])
        return a.reshape(RT, G)

    # NaN padding: every comparison against a padded ray is false
    nan = float("nan")
    fields = tuple(padded(p[k], nan) for k in range(3)) + \
        tuple(padded(d[k], nan) for k in range(3))
    return fields, RT


def _ray_tile_hits(rfields, tile_lo, tile_up, NB: int = 4):
    """(RT, T) int32 band bits: bit r set iff any ray of ray-tile rt's
    (G/NB)-ray band r hits leaf-tile t's AABB (forward slab test with the
    reference's NaN semantics, as ``isintersection``)."""
    RT, G = rfields[0].shape
    BH = G // NB

    def min2(a, b):
        return jnp.where(a < b, a, b)

    def max2(a, b):
        return jnp.where(a > b, a, b)

    tmin = None
    tmax = None
    for k in range(3):
        po = rfields[k].reshape(RT, NB, BH, 1)
        inv = (1.0 / rfields[3 + k]).reshape(RT, NB, BH, 1)
        t1 = (tile_lo[k][None, None, None, :] - po) * inv
        t2 = (tile_up[k][None, None, None, :] - po) * inv
        lo = min2(t1, t2)
        hi = max2(t1, t2)
        tmin = lo if tmin is None else max2(tmin, lo)
        tmax = hi if tmax is None else min2(tmax, hi)
    hit = jnp.any((tmin <= tmax) & (tmax >= 0), axis=2)       # (RT, NB, T)
    wts = jnp.left_shift(1, jnp.arange(NB, dtype=jnp.int32))
    return jnp.sum(jnp.where(hit, wts[None, :, None], 0), axis=1,
                   dtype=jnp.int32)


@partial(jax.jit, static_argnames=("capacity", "alg", "pair_capacity",
                                   "narrow"))
def traverse_rays_tiles_fixed(bvh: BVH, points, directions, capacity: int, *,
                              alg: "TileTraversal" = None,
                              pair_capacity: Optional[int] = None,
                              narrow=None):
    """Fully-traced fixed-capacity tile ray traversal.

    ``points``/``directions`` are (3, N) ray matrices.  Returns
    ``(total, contacts, overflow, num_checks)`` with contacts as
    (leaf_user_index, iray) pairs (1-based ray indices); ``overflow``
    (bit 0: contact buffer, bit 1: candidate list) means the
    :func:`traverse_rays_tiles` wrapper must grow; ``num_checks`` counts
    the ray-leaf tests of the live entries."""
    from ..raytrace import _prep_rays  # lazy: avoids an import cycle

    alg = alg or TileTraversal()
    G, NB = alg.tile, alg.bands
    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype)
    n_rays = p[0].shape[0]
    RT = -(-n_rays // G)
    if pair_capacity is None:
        pair_capacity = _ray_pair_capacity(RT, NB)
    fields, sphere, rfields, perm, ea, eb, ne = _ray_entries(
        bvh, p, d, G, NB, pair_capacity)
    gi, gj, raw_total = _band_contacts(
        rfields, fields, ea, eb, ne,
        "ray_sphere" if sphere else "ray_box", NB, dedup=False,
        capacity=capacity)

    # sorted ray position -> original 1-based ray index
    pad = RT * G - n_rays
    iray_map = perm.astype(jnp.int32) + 1
    if pad:
        iray_map = jnp.concatenate([iray_map, jnp.zeros((pad,), jnp.int32)])

    narrow_fn = None
    if narrow is not None:
        leaves = bvh.leaves
        rflat = tuple(f.reshape(-1) for f in rfields)

        def narrow_fn(gl, gr):
            leaf = jax.tree_util.tree_map(lambda x: x[gl], leaves)
            pp = tuple(rflat[k][gr] for k in range(3))
            dd = tuple(rflat[3 + k][gr] for k in range(3))
            return narrow(leaf, pp, dd)

    # gi = sorted ray positions, gj = sorted leaf positions; contact
    # columns are (leaf user index, 1-based ray index)
    total, contacts = _finish_contacts(
        gj, gi, raw_total, bvh.leaves.index, narrow_fn, capacity,
        leaf_index_b=iray_map, sort_pairs=False)
    overflow = _overflow_bits(raw_total > capacity, ne > pair_capacity)
    num_checks = ne.astype(jnp.float32) * ((G // NB) * G)
    return total, contacts, overflow, num_checks


def _ray_entries(bvh: BVH, p, d, G: int, NB: int, pair_capacity: int):
    """Phase 1 of ray traversal: ``(fields, sphere, rfields, perm, ea, eb,
    ne)`` — leaf tiles, coherence-sorted ray tiles and the live (ray band,
    leaf tile) entry list."""
    with jax.named_scope("tiles/phase1"):
        fields, sphere, tile_lo, tile_up, _, _, T = _tiled_fields(bvh, G)
        perm = _sort_rays(p, d)
        rfields, RT = _ray_tile_fields(p, d, perm, G)
        bits = _ray_tile_hits(rfields, tile_lo, tile_up, NB)   # (RT, T)
        idx, ne = _compact_flat(_live_bands(bits, NB),
                                jnp.arange(RT * T * NB, dtype=jnp.int32),
                                pair_capacity)
    return (fields, sphere, rfields, perm, (idx // (T * NB)) * NB + idx % NB,
            (idx // NB) % T, ne)


def _ray_pair_capacity(num_ray_tiles: int, bands: int) -> int:
    cap = num_ray_tiles * RAY_ENTRIES_PER_RAY_TILE * bands // 4
    return max(-(-cap // 8192) * 8192, 8192)


def traverse_rays_tiles(bvh: BVH, points, directions, *,
                        alg: "TileTraversal" = None, narrow=None,
                        cache: Optional[BVHTraversal] = None,
                        options: BVHOptions = DEFAULT_OPTIONS
                        ) -> BVHTraversal:
    """Host wrapper with overflow-driven capacity growth (ray tiles)."""
    alg = alg or TileTraversal()
    idt = bvh.skips.dtype
    n_rays = int(jnp.asarray(points).shape[1])
    if n_rays == 0 or bvh.tree.real_nodes < 1:
        return BVHTraversal(num_contacts=jnp.zeros((), idt),
                            cache1=jnp.zeros((0, 2), idt),
                            cache2=jnp.zeros((0,), idt), start_level1=1)
    capacity = _initial_capacity(4 * n_rays, options, cache)
    if cache is not None and cache.pair_capacity > 0:
        pair_capacity = cache.pair_capacity
    else:
        pair_capacity = _ray_pair_capacity(-(-n_rays // alg.tile),
                                           alg.bands)

    def run(cap, pcap):
        return traverse_rays_tiles_fixed(bvh, points, directions, cap,
                                         alg=alg, pair_capacity=pcap,
                                         narrow=narrow)

    done = _grow_loop(run, capacity, pair_capacity, options)
    if done is None:
        from ..raytrace import traverse_rays
        from .types import LVTTraversal
        return traverse_rays(bvh, points, directions, LVTTraversal(),
                             narrow=narrow, options=options)
    total, contacts, num_checks, pair_capacity = done
    return BVHTraversal(num_contacts=int(total), cache1=contacts,
                        cache2=jnp.zeros((0,), idt), start_level1=1,
                        num_checks=int(num_checks),
                        pair_capacity=pair_capacity, tile_alg=alg)
