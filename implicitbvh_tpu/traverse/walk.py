"""Stackless leaf-vs-tree walk engine — the LVT traversal core.

Vectorized replacement for the reference's per-thread stack walk
(/root/reference/src/traverse/leaf_vs_tree/traverse_single.jl:136-208 and
raytrace counterpart).  Instead of a 32-deep ``SimpleMVector`` stack per
work-item, every lane carries only its current implicit node index and
advances *stacklessly*:

- on a hit at a node level, descend to the left child (``inode * 2``);
- otherwise climb over the trailing-ones suffix (``t = ctz(inode + 1)``,
  the number of right-child edges below the deepest unexplored right
  sibling) and step to ``(inode >> t) + 1``.

This is an in-order walk of the exact same subtree set the reference visits,
but with O(1) per-lane state, which lets *all* lanes (leaves/rays) run in
lockstep as dense vector ops inside one ``lax.while_loop``: one gather of
node data + one vectorized overlap test + masked index updates per step.
Output uses the same two-pass count -> exclusive-scan -> write scheme as the
reference (traverse_single.jl:52-78), with the write pass scattering at
deterministic per-lane offsets — no atomics anywhere.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..tree import ImplicitTree
from ..utils import count_trailing_zeros, floor_ilog2
from ..volumes import Volume


def stackless_walk(
    tree: ImplicitTree,
    nodes: Volume,
    target_leaves,
    skips: jnp.ndarray,
    start_level: int,
    node_test: Callable,           # (node_volume_batch[K]) -> bool[K]
    leaf_test: Callable,           # (leaf_struct_batch[K]) -> bool[K]
    emit: Callable,                # (leaf_struct_batch[K]) -> int[K, 2]
    num_lanes: int,
    dedup_ileaf: Optional[jnp.ndarray] = None,  # int[K] implicit leaf index
    capacity: int = 0,
    offsets: Optional[jnp.ndarray] = None,      # int[K] write offsets
):
    """Run the walk for all lanes; returns (counts[K], out[capacity, 2]).

    With ``capacity == 0`` this is the counting pass.  With a nonzero
    ``capacity`` and per-lane ``offsets``, contacts are scattered into the
    output at ``offsets[k] + (running per-lane count)``.

    ``dedup_ileaf``: if given, subtrees whose rightmost reachable leaf is at
    or left of this implicit index are pruned — the reference's
    double-count-avoidance rule for self-traversal
    (traverse_single.jl (lvt):163-167).
    """
    levels = tree.levels
    num_n = max(tree.num_nodes, 1)
    num_l = tree.real_leaves
    idt = skips.dtype

    first_root = 1 << (start_level - 1)
    last_root = first_root + tree.level_nodes(start_level) - 1

    leaf_base = (1 << (levels - 1)) - 1  # implicit index of leaf j is j + leaf_base

    inode0 = jnp.full((num_lanes,), first_root, dtype=idt)
    counts0 = jnp.zeros((num_lanes,), dtype=idt)
    out0 = jnp.zeros((capacity, 2), dtype=idt)
    if offsets is None:
        offsets = jnp.zeros((num_lanes,), dtype=idt)

    virtual_leaves = jnp.asarray(tree.virtual_leaves, idt)

    def cond(carry):
        inode, _, _ = carry
        return jnp.any(inode > 0)

    def body(carry):
        inode, counts, out = carry
        active = inode > 0
        cur = jnp.maximum(inode, 1)

        level = floor_ilog2(cur) + 1  # 1-based level of each lane's node

        # Dedup prune: subtree entirely at/left of the lane's own leaf.
        if dedup_ileaf is not None:
            rightmost = ((cur + 1) << (levels - level)) - 1
            pruned = rightmost <= dedup_ileaf
        else:
            pruned = jnp.zeros_like(active)

        # Virtual check (lane may step onto a virtual right sibling).
        level_first = jnp.left_shift(jnp.ones_like(cur), level - 1)
        nreal = level_first - jnp.right_shift(virtual_leaves, levels - level)
        virt = cur - level_first + 1 > nreal

        at_leaf = level == levels

        # --- node test (masked; gather is clamped so inactive lanes are safe)
        if tree.num_nodes > 0:
            mem0 = jnp.clip(cur - skips[jnp.clip(level - 1, 0, levels - 1)] - 1,
                            0, num_n - 1)
            node_vol = jax.tree_util.tree_map(lambda a: a[mem0], nodes)
            hit_node = node_test(node_vol)
        else:  # single-leaf tree: no stored nodes, every visit is a leaf visit
            hit_node = jnp.zeros_like(active)
        descend = active & ~pruned & ~virt & ~at_leaf & hit_node

        # --- leaf test + emission
        jleaf0 = jnp.clip(cur - leaf_base - 1, 0, num_l - 1)
        leaf = jax.tree_util.tree_map(lambda a: a[jleaf0], target_leaves)
        hit_leaf = active & ~pruned & ~virt & at_leaf & leaf_test(leaf)

        counts_new = counts + hit_leaf.astype(idt)
        if capacity > 0:
            pos = jnp.where(hit_leaf, offsets + counts, capacity)
            out = out.at[pos].set(emit(leaf), mode="drop")

        # --- stackless advance: climb over trailing ones, step right.
        # The climb is capped at start_level: the walk covers a *forest* of
        # roots, so a climb that reaches the lane's current root means that
        # root's subtree is exhausted and the lane steps to the next root
        # (NOT to an uncle above start_level, which belongs to no root).
        t = count_trailing_zeros(cur + 1)
        depth = level - start_level  # >= 0 while walking
        root = jnp.right_shift(cur, jnp.maximum(depth, 0))
        subtree_done = t >= depth
        nxt = jnp.where(subtree_done, root + 1, jnp.right_shift(cur, t) + 1)
        done = subtree_done & (root + 1 > last_root)
        nxt = jnp.where(done, 0, nxt)

        inode_next = jnp.where(descend, 2 * cur, nxt)
        inode_next = jnp.where(active, inode_next, 0)
        return inode_next, counts_new, out

    _, counts, out = jax.lax.while_loop(cond, body, (inode0, counts0, out0))
    return counts, out
