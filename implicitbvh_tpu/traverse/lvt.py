"""Leaf-vs-tree traversal drivers (single BVH and BVH-vs-BVH).

Counterpart of /root/reference/src/traverse/leaf_vs_tree/.
The per-leaf stack walk becomes the stackless lockstep walk of walk.py; the
count -> exclusive-scan -> write output scheme is identical in structure to
the reference (traverse_single.jl:52-78), with ``jnp.cumsum`` standing in
for ``AK.accumulate!`` and deterministic scatters for per-thread writes.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..build import BVH, Leaves
from ..volumes import convert_volume, iscontact
from .types import BVHTraversal
from .walk import stackless_walk


def default_start_level_lvt(bvh: BVH) -> int:
    """Ref: leaf_vs_tree.jl:4-6."""
    return max(1, bvh.built_level)


def _empty_traversal(bvh: BVH, start_level: int, start_level2: int = 0):
    idt = bvh.skips.dtype
    return BVHTraversal(
        num_contacts=jnp.zeros((), idt),
        cache1=jnp.zeros((0, 2), idt),
        cache2=jnp.zeros((0,), idt),
        start_level1=start_level, start_level2=start_level2)


# --------------------------------------------------------------------------
# Single-BVH self-contact
# --------------------------------------------------------------------------

def _single_closures(bvh: BVH, narrow):
    """Vectorized node/leaf tests + emitter for all N leaf lanes."""
    q = bvh.leaves
    q_node_vol = convert_volume(bvh.node_kind, q.volume)

    def node_test(node_vol):
        return iscontact(q_node_vol, node_vol)

    def leaf_test(leaf: Leaves):
        hit = iscontact(q.volume, leaf.volume)
        if narrow is not None:
            hit = hit & narrow(q, leaf)
        return hit

    def emit(leaf: Leaves):
        # Single-tree traversal emits sorted (min, max) user-index pairs
        # (ref traverse_single.jl (lvt):176-180).
        a = jnp.minimum(q.index, leaf.index)
        b = jnp.maximum(q.index, leaf.index)
        return jnp.stack([a, b], axis=-1)

    return node_test, leaf_test, emit


@partial(jax.jit, static_argnames=("start_level", "narrow"))
def lvt_count_single(bvh: BVH, start_level: int, narrow=None):
    """Counting pass: per-lane contact counts (K,)."""
    node_test, leaf_test, emit = _single_closures(bvh, narrow)
    n = bvh.num_leaves
    idt = bvh.skips.dtype
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    dedup = jnp.arange(1, n + 1, dtype=idt) + leaf_base
    counts, _ = stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        node_test, leaf_test, emit, num_lanes=n, dedup_ileaf=dedup)
    return counts


@partial(jax.jit, static_argnames=("start_level", "narrow", "capacity"))
def lvt_write_single(bvh: BVH, offsets, start_level: int, capacity: int,
                     narrow=None):
    """Writing pass at precomputed per-lane offsets."""
    node_test, leaf_test, emit = _single_closures(bvh, narrow)
    n = bvh.num_leaves
    idt = bvh.skips.dtype
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    dedup = jnp.arange(1, n + 1, dtype=idt) + leaf_base
    _, out = stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        node_test, leaf_test, emit, num_lanes=n, dedup_ileaf=dedup,
        capacity=capacity, offsets=offsets)
    return out


def traverse_lvt_single_fixed(bvh: BVH, capacity: int, *,
                              start_level: Optional[int] = None, narrow=None):
    """Fully-traced fixed-capacity self-contact traversal.

    Returns ``(total, contacts)`` with ``total`` a device scalar; the first
    ``min(total, capacity)`` rows of ``contacts`` are valid.  This is the
    zero-host-sync API used inside fused rebuild+traverse pipelines.
    """
    if start_level is None:
        start_level = default_start_level_lvt(bvh)
    counts = lvt_count_single(bvh, start_level, narrow)
    offsets = jnp.cumsum(counts) - counts  # exclusive scan
    total = counts.sum()
    out = lvt_write_single(bvh, offsets, start_level, capacity, narrow)
    return total, out


# --------------------------------------------------------------------------
# BVH-vs-BVH
# --------------------------------------------------------------------------

def _pair_closures(lanes: Leaves, target: BVH, narrow, flip: bool):
    q = lanes
    q_node_vol = convert_volume(target.node_kind, q.volume)

    def node_test(node_vol):
        return iscontact(q_node_vol, node_vol)

    def leaf_test(leaf: Leaves):
        hit = iscontact(q.volume, leaf.volume)
        if narrow is not None:
            hit = hit & (narrow(leaf, q) if flip else narrow(q, leaf))
        return hit

    def emit(leaf: Leaves):
        # Pair traversal keeps tree order (i1, i2) (ref traverse_pair.jl:211-216).
        if flip:
            return jnp.stack([leaf.index, q.index], axis=-1)
        return jnp.stack([q.index, leaf.index], axis=-1)

    return node_test, leaf_test, emit


@partial(jax.jit, static_argnames=("start_level2", "narrow", "flip"))
def lvt_count_pair(lanes: Leaves, target: BVH, start_level2: int,
                   narrow=None, flip: bool = False):
    node_test, leaf_test, emit = _pair_closures(lanes, target, narrow, flip)
    n = lanes.index.shape[0]
    counts, _ = stackless_walk(
        target.tree, target.nodes, target.leaves, target.skips, start_level2,
        node_test, leaf_test, emit, num_lanes=n)
    return counts


@partial(jax.jit, static_argnames=("start_level2", "narrow", "flip", "capacity"))
def lvt_write_pair(lanes: Leaves, target: BVH, offsets, start_level2: int,
                   capacity: int, narrow=None, flip: bool = False):
    node_test, leaf_test, emit = _pair_closures(lanes, target, narrow, flip)
    n = lanes.index.shape[0]
    _, out = stackless_walk(
        target.tree, target.nodes, target.leaves, target.skips, start_level2,
        node_test, leaf_test, emit, num_lanes=n,
        capacity=capacity, offsets=offsets)
    return out


def traverse_lvt_pair_fixed(bvh1: BVH, bvh2: BVH, capacity: int, *,
                            start_level1: Optional[int] = None,
                            start_level2: Optional[int] = None,
                            narrow=None):
    """Fully-traced fixed-capacity pair traversal; returns (total, contacts).

    The BVH with more leaves supplies the iterated lanes and the other tree
    is walked (ref traverse_pair.jl:15-37); ``flip`` restores contact order.
    """
    if start_level1 is None:
        start_level1 = default_start_level_lvt(bvh1)
    if start_level2 is None:
        start_level2 = default_start_level_lvt(bvh2)
    if bvh1.num_leaves >= bvh2.num_leaves:
        lanes, target, sl, flip = bvh1.leaves, bvh2, start_level2, False
    else:
        lanes, target, sl, flip = bvh2.leaves, bvh1, start_level1, True
    counts = lvt_count_pair(lanes, target, sl, narrow, flip)
    offsets = jnp.cumsum(counts) - counts
    total = counts.sum()
    out = lvt_write_pair(lanes, target, offsets, sl, capacity, narrow, flip)
    return total, out
