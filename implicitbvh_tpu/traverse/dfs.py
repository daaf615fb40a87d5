"""Depth-first (DFS) self-contact traversal.

Behavioral counterpart of the reference's experimental ``DFSTraversal``
(/root/reference/src/traverse/depth_first/traverse_single.jl, gated off
upstream at src/traverse/traverse.jl:261): single-BVH contact detection
that descends pair-subtrees depth-first instead of expanding a global
BVTT frontier.  Contact sets are identical to LVT/BFS.

A redesign, not a translation: the reference interleaves a
per-level 4-wide check matrix with fixed-size stack buffers per thread;
here every *lane* is one initial BVTT pair at ``start_level`` and carries
an explicit per-lane stack of (i1, i2) implicit pairs in two (lanes,
DEPTH) arrays — all lanes advance in lockstep inside one
``lax.while_loop`` (pop -> vectorized iscontact -> masked 4-way push),
with the LVT-style two-pass count -> exclusive-scan -> write output
scheme.  Depth is bounded by construction: each pop that pushes removes
one slot and adds at most four, descending one level, so DEPTH =
3 * levels + 4 suffices.

Virtual-node and self-pair sprouting rules replicate the single-tree BFS
machine exactly (i1 < i2 for pair checks so only i2's right child can be
virtual, ref traverse_single_cpu.jl:110-121; (i, i) self pairs sprout
(ll, lr, rr) with ll/rr suppressed at the level above the leaves).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..build import BVH
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..utils import floor_ilog2
from ..volumes import iscontact
from .bfs import (_gather_leaves, _gather_nodes_traced, _initial_bvtt_single,
                  _virt_child_traced)
from .types import BVHTraversal, TraversalAlgorithm


@dataclasses.dataclass(frozen=True)
class DFSTraversal(TraversalAlgorithm):
    """Depth-first traversal (ref depth_first/traverse_single.jl:1-40).

    Single-BVH self-contact only, like the reference.  Peak memory is
    lanes x (3 * levels) stack slots where lanes is the initial BVTT size
    at ``start_level`` — prefer deeper start levels for large trees.
    """


def _stack_depth(levels: int, start_level: int) -> int:
    return 3 * max(levels - start_level, 1) + 4


@partial(jax.jit, static_argnames=("start_level", "narrow", "capacity"))
def dfs_single_fixed(bvh: BVH, start_level: int, capacity: int = 0,
                     offsets=None, narrow=None):
    """One DFS pass over all lanes; returns ``(counts, out)``.

    ``capacity == 0``: counting pass.  With ``capacity`` and per-lane
    ``offsets``: write pass scattering sorted (min, max) user-index pairs
    at deterministic offsets (no atomics).
    """
    tree = bvh.tree
    idt = bvh.skips.dtype
    levels = tree.levels

    i1_0, i2_0 = _initial_bvtt_single(bvh, start_level, idt)
    lanes = i1_0.shape[0]
    DEPTH = _stack_depth(levels, start_level)

    # stacks hold pending pairs; slot 0 is seeded with the lane's own pair
    st1 = jnp.zeros((lanes, DEPTH), idt).at[:, 0].set(i1_0)
    st2 = jnp.zeros((lanes, DEPTH), idt).at[:, 0].set(i2_0)
    sp0 = jnp.ones((lanes,), idt)
    counts0 = jnp.zeros((lanes,), idt)
    out0 = jnp.zeros((max(capacity, 1), 2), idt)
    if offsets is None:
        offsets = jnp.zeros((lanes,), idt)
    lane_ids = jnp.arange(lanes)

    def cond(carry):
        _, _, sp, _, _ = carry
        return jnp.any(sp > 0)

    def body(carry):
        st1, st2, sp, counts, out = carry
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        i1 = jnp.take_along_axis(st1, top[:, None], axis=1)[:, 0]
        i2 = jnp.take_along_axis(st2, top[:, None], axis=1)[:, 0]
        sp = jnp.where(active, sp - 1, sp)

        i1c = jnp.maximum(i1, 1)
        i2c = jnp.maximum(i2, 1)
        level = floor_ilog2(i1c) + 1     # pair nodes share one level
        at_leaf = level == levels
        is_self = (i1 == i2) & active
        self_checks = level < levels - 1

        # --- leaf-leaf contact (ref traverse_single_cpu.jl:184-219) ------
        leaf1 = _gather_leaves(bvh, i1c)
        leaf2 = _gather_leaves(bvh, i2c)
        hit_leaf = active & at_leaf & ~is_self & \
            iscontact(leaf1.volume, leaf2.volume)
        if narrow is not None:
            hit_leaf = hit_leaf & narrow(leaf1, leaf2)
        counts_new = counts + hit_leaf.astype(idt)
        if capacity > 0:
            a = jnp.minimum(leaf1.index, leaf2.index)
            b = jnp.maximum(leaf1.index, leaf2.index)
            pos = jnp.where(hit_leaf, offsets + counts, capacity)
            out = out.at[pos].set(jnp.stack([a, b], axis=-1), mode="drop")

        # --- node-pair test + 4-way depth-first sprout -------------------
        v1 = _gather_nodes_traced(bvh, i1c, level)
        v2 = _gather_nodes_traced(bvh, i2c, level)
        hit = active & ~at_leaf & ~is_self & iscontact(v1, v2)
        virt2 = _virt_child_traced(tree, i2c, level, idt)
        l1, r1 = 2 * i1c, 2 * i1c + 1
        l2, r2 = 2 * i2c, 2 * i2c + 1
        pushes = [
            (l1, l2, (is_self & self_checks & ~at_leaf) | hit),
            (l1, r2, ((is_self & ~at_leaf) | hit) & ~virt2),
            (r1, l2, hit),
            (r1, r2, ((is_self & self_checks & ~at_leaf) | hit) & ~virt2),
        ]
        npush = jnp.zeros((lanes,), idt)
        for p1, p2, ok in pushes:
            dst = jnp.where(ok, sp + npush, DEPTH)
            st1 = st1.at[lane_ids, dst].set(p1, mode="drop")
            st2 = st2.at[lane_ids, dst].set(p2, mode="drop")
            npush = npush + ok.astype(idt)
        sp = sp + npush
        return st1, st2, sp, counts_new, out

    _, _, _, counts, out = jax.lax.while_loop(
        cond, body, (st1, st2, sp0, counts0, out0))
    return counts, out


def traverse_dfs_single(bvh: BVH, *, start_level: int, narrow=None,
                        cache=None,
                        options: BVHOptions = DEFAULT_OPTIONS
                        ) -> BVHTraversal:
    """Host wrapper: count pass -> exclusive scan -> write pass (the LVT
    two-pass scheme, ref traverse_single.jl:52-78), one host sync."""
    import math

    counts, _ = dfs_single_fixed(bvh, start_level, narrow=narrow)
    offsets = jnp.cumsum(counts) - counts
    total = int(counts.sum())
    need = max(total, options.min_capacity)
    if cache is not None and getattr(cache, "cache1", None) is not None \
            and cache.cache1.ndim == 2 and cache.cache1.shape[0] >= need:
        capacity = cache.cache1.shape[0]
    else:
        capacity = 1 << math.ceil(math.log2(need))
    _, out = dfs_single_fixed(bvh, start_level, capacity=capacity,
                              offsets=offsets, narrow=narrow)
    return BVHTraversal(num_contacts=total, cache1=out, cache2=offsets,
                        start_level1=start_level)
