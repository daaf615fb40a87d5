"""Ray tracing: batched rays vs BVH.

Counterpart of /root/reference/src/raytrace/.  The leaf-vs-tree algorithm
reuses the stackless walk engine with one lane per ray and ``isintersection`` in place of ``iscontact``
(ref raytrace/leaf_vs_tree/leaf_vs_tree.jl:170-228); output is
``(leaf_user_index, ray_index)`` pairs with 1-based ray indices.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .build import BVH, Leaves
from .options import DEFAULT_OPTIONS, BVHOptions
from .traverse.types import BFSTraversal, BVHTraversal, TraversalAlgorithm
from .traverse.tiles import TileTraversal
from .traverse.walk import stackless_walk
from .volumes import isintersection


def _ray_closures(bvh: BVH, points, directions, narrow):
    """points/directions are (K, 3) lane arrays."""

    def node_test(node_vol):
        return isintersection(node_vol, points, directions)

    def leaf_test(leaf: Leaves):
        hit = isintersection(leaf.volume, points, directions)
        if narrow is not None:
            hit = hit & narrow(leaf, points, directions)
        return hit

    k = points[0].shape[0]
    idt = bvh.skips.dtype
    iray = jnp.arange(1, k + 1, dtype=idt)

    def emit(leaf: Leaves):
        return jnp.stack([leaf.index, iray], axis=-1)

    return node_test, leaf_test, emit


@partial(jax.jit, static_argnames=("start_level", "narrow"))
def rays_count(bvh: BVH, points, directions, start_level: int, narrow=None):
    node_test, leaf_test, emit = _ray_closures(bvh, points, directions, narrow)
    counts, _ = stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        node_test, leaf_test, emit, num_lanes=points[0].shape[0])
    return counts


@partial(jax.jit, static_argnames=("start_level", "narrow", "capacity"))
def rays_write(bvh: BVH, points, directions, offsets, start_level: int,
               capacity: int, narrow=None):
    node_test, leaf_test, emit = _ray_closures(bvh, points, directions, narrow)
    _, out = stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        node_test, leaf_test, emit, num_lanes=points[0].shape[0],
        capacity=capacity, offsets=offsets)
    return out


def _prep_rays(points, directions, dtype):
    """Validate (3, N) ray matrices and split into coordinate tuples of
    (N,) lane arrays (the SoA layout, see volumes.py)."""
    points = jnp.asarray(points, dtype)
    directions = jnp.asarray(directions, dtype)
    if points.ndim != 2 or points.shape[0] != 3:
        raise ValueError(f"points must be (3, N), got {points.shape}")
    if directions.shape != points.shape:
        raise ValueError("points and directions must have the same shape")
    p = (points[0], points[1], points[2])
    d = (directions[0], directions[1], directions[2])
    return p, d


def traverse_rays_fixed(bvh: BVH, points, directions, capacity: int, *,
                        start_level: int = 1, narrow=None):
    """Fully-traced fixed-capacity ray traversal; returns (total, contacts).

    Rays are given as (3, N) matrices (reference convention,
    ref raytrace.jl:88-91); contacts are (leaf_index, iray) pairs.
    """
    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype)
    counts = rays_count(bvh, p, d, start_level, narrow)
    offsets = jnp.cumsum(counts) - counts
    total = counts.sum()
    out = rays_write(bvh, p, d, offsets, start_level, capacity, narrow)
    return total, out


def traverse_rays(bvh: BVH, points, directions,
                  alg: Optional[TraversalAlgorithm] = None, *,
                  start_level: int = 1,
                  narrow=None,
                  cache: Optional[BVHTraversal] = None,
                  options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """Intersections of N forward rays with the BVH leaves
    (ref traverse_rays, src/raytrace/raytrace.jl:71-100).

    ``points``/``directions`` have shape (3, N).  Returns a
    :class:`BVHTraversal` whose contacts are ``(leaf_user_index, iray)``
    with 1-based ray indices.  ``narrow(leaf, p, d)`` is an optional
    vectorized narrow-phase predicate.

    With no explicit ``alg`` the engine measured fastest for rays on the
    backend is chosen (``traverse.api.default_algorithm``; the reference
    routes its default the same way, ref src/traverse/traverse.jl:26-34).
    Pass ``LVTTraversal()``/``BFSTraversal()``/``TileTraversal()`` to force
    one.
    """
    if alg is None:
        from .traverse.api import default_algorithm
        alg = default_algorithm("rays", bvh)
    if not (bvh.built_level <= start_level <= bvh.tree.levels):
        raise ValueError(f"invalid start_level {start_level}")

    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype)
    idt = bvh.skips.dtype
    if p[0].shape[0] == 0 or bvh.tree.real_nodes < 1:
        return BVHTraversal(num_contacts=jnp.zeros((), idt),
                            cache1=jnp.zeros((0, 2), idt),
                            cache2=jnp.zeros((0,), idt),
                            start_level1=start_level)

    if isinstance(alg, BFSTraversal):
        from .traverse import bfs as _bfs
        return _bfs.traverse_rays_bfs(bvh, p, d, start_level=start_level,
                                      narrow=narrow, options=options)

    if isinstance(alg, TileTraversal):
        from .traverse.ray_tiles import traverse_rays_tiles
        return traverse_rays_tiles(bvh, points, directions, alg=alg,
                                   narrow=narrow, cache=cache,
                                   options=options)

    counts = rays_count(bvh, p, d, start_level, narrow)
    offsets = jnp.cumsum(counts) - counts
    total = int(counts.sum())
    need = max(total, options.min_capacity)
    if cache is not None and cache.cache1.ndim == 2 \
            and cache.cache1.shape[0] >= need:
        capacity = cache.cache1.shape[0]   # re-use the compiled capacity
    else:
        capacity = 1 << math.ceil(math.log2(need))
    out = rays_write(bvh, p, d, offsets, start_level, capacity, narrow)
    return BVHTraversal(num_contacts=total, cache1=out, cache2=offsets,
                        start_level1=start_level)
