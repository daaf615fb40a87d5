"""Breadth-first (BVTT frontier) traversal — single, pair, and rays.

Counterpart of /root/reference/src/traverse/breadth_first/ and
/root/reference/src/raytrace/breadth_first/.

The reference's dynamically-resized BVTT double buffer + per-task prefix-sum
repack (CPU) / two-level atomic queues (GPU) becomes, in XLA:

- **static-capacity** frontier buffers with a validity count,
- per level: one gather of node volumes, one vectorized overlap test,
  masked 4-way (or 2-way) child sprouting, and deterministic stream
  compaction via ``cumsum`` + scatter-drop — no atomics, bitwise
  reproducible,
- an overflow flag instead of ``resize!``; the host wrapper re-runs with a
  doubled capacity when the frontier spikes past the static buffer (the
  reference documents 10-20x spikes, traverse.jl:22-23).

Because the tree shape is jit-static, the level loop (and the pair
traversal's 6-phase unequal-height state machine, ref traverse_pair.jl:49-147)
unrolls into a flat fused XLA program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..build import BVH
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..utils import (k2ij_exclusive, leftleft, leftnoop, leftright,
                     noopleft, noopright, rightleft, rightnoop, rightright)
from ..volumes import iscontact, isintersection
from .types import BVHTraversal


# --------------------------------------------------------------------------
# Shared machinery
# --------------------------------------------------------------------------

def _compact(valid, vals1, vals2, capacity, idt):
    """Deterministic stream compaction of (vals1, vals2) where valid.

    Returns (o1, o2, total).  Entries beyond ``capacity`` are dropped (the
    caller checks ``total > capacity`` for overflow).
    """
    v = valid.astype(idt)
    pos = jnp.cumsum(v) - v              # exclusive scan
    posx = jnp.where(valid, pos, capacity)
    o1 = jnp.zeros((capacity,), idt).at[posx].set(vals1, mode="drop")
    o2 = jnp.zeros((capacity,), idt).at[posx].set(vals2, mode="drop")
    return o1, o2, v.sum()


def _expand(slots, capacity, idt):
    """Compact a list of sprout slots [(v1, v2, valid), ...] into the next
    frontier.  Slot arrays are stacked then flattened in slot-major order of
    the source pair, preserving the reference's per-pair emission grouping.
    """
    v1 = jnp.stack([s[0] for s in slots], axis=-1).reshape(-1)
    v2 = jnp.stack([s[1] for s in slots], axis=-1).reshape(-1)
    ok = jnp.stack([s[2] for s in slots], axis=-1).reshape(-1)
    return _compact(ok, v1, v2, capacity, idt)


def _gather_nodes(bvh: BVH, implicit, level: int):
    """Gather node volumes for implicit indices on a *static* level."""
    skips = bvh.tree.virtual_nodes_before_level(level)
    num_n = max(bvh.tree.num_nodes, 1)
    m = jnp.clip(implicit - skips - 1, 0, num_n - 1)
    return jax.tree_util.tree_map(lambda a: a[m], bvh.nodes)


def _gather_leaves(bvh: BVH, implicit):
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    j = jnp.clip(implicit - leaf_base - 1, 0, bvh.tree.real_leaves - 1)
    return jax.tree_util.tree_map(lambda a: a[j], bvh.leaves)


def _virt_child(tree, i, level: int):
    """Is implicit child ``2i + 1`` (on static ``level + 1``) virtual?"""
    nreal_next = tree.level_nodes(level + 1)
    first_next = 1 << level
    return (2 * i + 1) - first_next + 1 > nreal_next


def _gather_nodes_traced(bvh: BVH, implicit, level):
    """Gather node volumes for implicit indices on a *traced* level (used
    by the DFS engine, whose per-lane stacks mix levels)."""
    num_n = max(bvh.tree.num_nodes, 1)
    lv = jnp.clip(level - 1, 0, bvh.tree.levels - 1)
    m = jnp.clip(implicit - bvh.skips[lv] - 1, 0, num_n - 1)
    return jax.tree_util.tree_map(lambda a: a[m], bvh.nodes)


def _virt_child_traced(tree, i, level, idt):
    """Is implicit child ``2i + 1`` (on traced ``level + 1``) virtual?"""
    levels = tree.levels
    virtual_leaves = jnp.asarray(tree.virtual_leaves, idt)
    one = jnp.ones_like(i)
    first_next = jnp.left_shift(one, level)
    shift = jnp.clip(levels - (level + 1), 0, levels)
    nreal_next = first_next - jnp.right_shift(virtual_leaves, shift)
    return (2 * i + 1) - first_next + 1 > nreal_next


# --------------------------------------------------------------------------
# Single-BVH BFS
# --------------------------------------------------------------------------

def _initial_bvtt_single(bvh: BVH, start_level: int, idt):
    """All (i, j<=i...) pair checks at start_level (ref
    traverse_single.jl:64-167): n*(n-1)/2 ordered pairs plus n self-check
    pairs when above leaf level.  Sizes are static."""
    n = bvh.tree.level_nodes(start_level)
    first = 1 << (start_level - 1)
    n_lin = n * (n - 1) // 2
    k = jnp.arange(n_lin, dtype=idt)
    pi, pj = k2ij_exclusive(n, k)
    i1 = pi + first
    i2 = pj + first
    if start_level != bvh.tree.levels:
        s = jnp.arange(first, first + n, dtype=idt)
        i1 = jnp.concatenate([i1, s])
        i2 = jnp.concatenate([i2, s])
    return i1, i2


@partial(jax.jit, static_argnames=("start_level", "narrow", "capacity"))
def bfs_single_fixed(bvh: BVH, start_level: int, capacity: int, narrow=None):
    """One fused program: frontier expansion from start_level to the leaves,
    then the leaf-leaf contact pass.  Returns
    (total_contacts, contacts[capacity, 2], num_checks, overflow)."""
    tree = bvh.tree
    idt = bvh.skips.dtype
    levels = tree.levels

    i1, i2 = _initial_bvtt_single(bvh, start_level, idt)
    n = jnp.asarray(i1.shape[0], idt)
    num_checks = n
    overflow = jnp.zeros((), jnp.bool_)

    # pad initial frontier into the working capacity
    def pad(a):
        return jnp.concatenate(
            [a, jnp.zeros((max(capacity - a.shape[0], 0),), idt)])[:capacity]
    if i1.shape[0] > capacity:
        overflow = jnp.ones((), jnp.bool_)
    i1, i2 = pad(i1), pad(i2)

    lane = jnp.arange(capacity, dtype=idt)
    for level in range(start_level, levels):
        mask = lane < n
        is_self = (i1 == i2) & mask
        self_checks = level < levels - 1

        v1 = _gather_nodes(bvh, i1, level)
        v2 = _gather_nodes(bvh, i2, level)
        hit = iscontact(v1, v2) & mask & ~is_self

        # In single-tree traversal i1 < i2 for pair checks, so i1's children
        # are always real; only i2's right child may be virtual
        # (ref traverse_single_cpu.jl:110-121).
        virt2 = _virt_child(tree, i2, level)
        ll, lr = leftleft(i1, i2), leftright(i1, i2)
        rl, rr = rightleft(i1, i2), rightright(i1, i2)

        slots = [
            # self (i,i) -> (2i,2i), (2i,2i+1), (2i+1,2i+1); pair -> 4-way
            (*ll, (is_self & self_checks) | hit),
            (*lr, (is_self | hit) & ~virt2),
            (*rl, hit),
            (*rr, (is_self & self_checks & ~virt2) | (hit & ~virt2)),
        ]
        i1, i2, n = _expand(slots, capacity, idt)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)

    # leaf-leaf pass (ref traverse_leaves_range!, traverse_single_cpu.jl:184-219)
    mask = lane < n
    leaf1 = _gather_leaves(bvh, i1)
    leaf2 = _gather_leaves(bvh, i2)
    hit = iscontact(leaf1.volume, leaf2.volume) & mask
    if narrow is not None:
        hit = hit & narrow(leaf1, leaf2)
    a = jnp.minimum(leaf1.index, leaf2.index)
    b = jnp.maximum(leaf1.index, leaf2.index)
    o1, o2, total = _compact(hit, a, b, capacity, idt)
    overflow = overflow | (total > capacity)
    return total, jnp.stack([o1, o2], axis=-1), num_checks, overflow


def _run_with_growth(fn, capacity0: int, options: BVHOptions, max_tries=10):
    cap = capacity0
    for _ in range(max_tries):
        total, out, num_checks, overflow = fn(cap)
        if not bool(overflow):
            return int(total), out, int(num_checks)
        cap = int(cap * options.capacity_growth)
    raise RuntimeError(f"BFS frontier kept overflowing (capacity {cap})")


def _bfs_capacity0(n_init: int, num_leaves: int, options: BVHOptions) -> int:
    import math
    need = max(options.min_capacity, 4 * n_init, 8 * num_leaves)
    return 1 << math.ceil(math.log2(need))


def traverse_bfs_single(bvh: BVH, *, start_level: int, narrow=None,
                        cache=None, options: BVHOptions = DEFAULT_OPTIONS):
    n = bvh.tree.level_nodes(start_level)
    n_init = n * (n + 1) // 2
    if cache is not None and getattr(cache, "cache1", None) is not None \
            and cache.cache1.ndim == 2 and cache.cache1.shape[0] > 0:
        cap0 = cache.cache1.shape[0]   # re-use the compiled capacity
    else:
        cap0 = _bfs_capacity0(n_init, bvh.num_leaves, options)
    total, out, num_checks = _run_with_growth(
        lambda c: bfs_single_fixed(bvh, start_level, c, narrow), cap0, options)
    return BVHTraversal(num_contacts=total, cache1=out,
                        cache2=jnp.zeros((0,), bvh.skips.dtype),
                        start_level1=start_level, num_checks=num_checks)


# --------------------------------------------------------------------------
# Pair BFS — 6-phase unequal-height state machine (ref traverse_pair.jl)
# --------------------------------------------------------------------------

def _initial_bvtt_pair(bvh1: BVH, bvh2: BVH, sl1: int, sl2: int, idt):
    """Full num_real1 x num_real2 cross product (ref traverse_pair.jl:154-219)."""
    n1 = bvh1.tree.level_nodes(sl1)
    n2 = bvh2.tree.level_nodes(sl2)
    f1 = 1 << (sl1 - 1)
    f2 = 1 << (sl2 - 1)
    k = jnp.arange(n1 * n2, dtype=idt)
    return k // n2 + f1, k % n2 + f2


@partial(jax.jit, static_argnames=("sl1", "sl2", "narrow", "capacity"))
def bfs_pair_fixed(bvh1: BVH, bvh2: BVH, sl1: int, sl2: int, capacity: int,
                   narrow=None):
    t1, t2 = bvh1.tree, bvh2.tree
    L1, L2 = t1.levels, t2.levels
    idt = bvh1.skips.dtype

    i1, i2 = _initial_bvtt_pair(bvh1, bvh2, sl1, sl2, idt)
    n = jnp.asarray(i1.shape[0], idt)
    num_checks = n
    overflow = jnp.asarray(i1.shape[0] > capacity)

    def pad(a):
        return jnp.concatenate(
            [a, jnp.zeros((max(capacity - a.shape[0], 0),), idt)])[:capacity]
    i1, i2 = pad(i1), pad(i2)
    lane = jnp.arange(capacity, dtype=idt)

    def step(slots, n):
        new1, new2, n2_ = _expand(slots, capacity, idt)
        return new1, new2, n2_

    level1, level2 = sl1, sl2
    # Phase A: both BVHs above their last node level — 4-way sprout
    while level1 < L1 - 1 and level2 < L2 - 1:
        mask = lane < n
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & mask
        virt1 = _virt_child(t1, i1, level1)
        virt2 = _virt_child(t2, i2, level2)
        slots = [
            (*leftleft(i1, i2), hit),
            (*leftright(i1, i2), hit & ~virt2),
            (*rightleft(i1, i2), hit & ~virt1),
            (*rightright(i1, i2), hit & ~virt1 & ~virt2),
        ]
        i1, i2, n = step(slots, n)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)
        level1 += 1
        level2 += 1

    # Phase B: only BVH1 still above its last node level — 2-way left sprout
    while level1 < L1 - 1 and level2 == L2 - 1:
        mask = lane < n
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & mask
        virt1 = _virt_child(t1, i1, level1)
        slots = [(*leftnoop(i1, i2), hit),
                 (*rightnoop(i1, i2), hit & ~virt1)]
        i1, i2, n = step(slots, n)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)
        level1 += 1

    # Phase C: only BVH2 still above its last node level — 2-way right sprout
    while level2 < L2 - 1 and level1 == L1 - 1:
        mask = lane < n
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & mask
        virt2 = _virt_child(t2, i2, level2)
        slots = [(*noopleft(i1, i2), hit),
                 (*noopright(i1, i2), hit & ~virt2)]
        i1, i2, n = step(slots, n)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)
        level2 += 1

    # Phase D: BVH2 already at leaf level — node1-vs-leaf2 checks
    while level2 == L2 and level1 < L1:
        mask = lane < n
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_leaves(bvh2, i2).volume) & mask
        virt1 = _virt_child(t1, i1, level1)
        slots = [(*leftnoop(i1, i2), hit),
                 (*rightnoop(i1, i2), hit & ~virt1)]
        i1, i2, n = step(slots, n)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)
        level1 += 1

    # Phase E: BVH1 already at leaf level — leaf1-vs-node2 checks
    while level1 == L1 and level2 < L2:
        mask = lane < n
        hit = iscontact(_gather_leaves(bvh1, i1).volume,
                        _gather_nodes(bvh2, i2, level2)) & mask
        virt2 = _virt_child(t2, i2, level2)
        slots = [(*noopleft(i1, i2), hit),
                 (*noopright(i1, i2), hit & ~virt2)]
        i1, i2, n = step(slots, n)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)
        level2 += 1

    # Phase F: both at the level above leaves — final 4-way sprout
    if level1 == L1 - 1 and level2 == L2 - 1:
        mask = lane < n
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & mask
        virt1 = _virt_child(t1, i1, level1)
        virt2 = _virt_child(t2, i2, level2)
        slots = [
            (*leftleft(i1, i2), hit),
            (*leftright(i1, i2), hit & ~virt2),
            (*rightleft(i1, i2), hit & ~virt1),
            (*rightright(i1, i2), hit & ~virt1 & ~virt2),
        ]
        i1, i2, n = step(slots, n)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)
        level1 += 1
        level2 += 1

    # Leaf-leaf pass: unsorted (i1, i2) tree-order emission
    # (ref traverse_leaves_pair_range!, traverse_pair_cpu.jl:615-645)
    mask = lane < n
    leaf1 = _gather_leaves(bvh1, i1)
    leaf2 = _gather_leaves(bvh2, i2)
    hit = iscontact(leaf1.volume, leaf2.volume) & mask
    if narrow is not None:
        hit = hit & narrow(leaf1, leaf2)
    o1, o2, total = _compact(hit, leaf1.index, leaf2.index, capacity, idt)
    overflow = overflow | (total > capacity)
    return total, jnp.stack([o1, o2], axis=-1), num_checks, overflow


def traverse_bfs_pair(bvh1: BVH, bvh2: BVH, *, start_level1: int,
                      start_level2: int, narrow=None, cache=None,
                      options: BVHOptions = DEFAULT_OPTIONS):
    n_init = (bvh1.tree.level_nodes(start_level1) *
              bvh2.tree.level_nodes(start_level2))
    if cache is not None and getattr(cache, "cache1", None) is not None \
            and cache.cache1.ndim == 2 and cache.cache1.shape[0] > 0:
        cap0 = cache.cache1.shape[0]   # re-use the compiled capacity
    else:
        cap0 = _bfs_capacity0(n_init, max(bvh1.num_leaves, bvh2.num_leaves),
                              options)
    total, out, num_checks = _run_with_growth(
        lambda c: bfs_pair_fixed(bvh1, bvh2, start_level1, start_level2, c,
                                 narrow), cap0, options)
    return BVHTraversal(num_contacts=total, cache1=out,
                        cache2=jnp.zeros((0,), bvh1.skips.dtype),
                        start_level1=start_level1, start_level2=start_level2,
                        num_checks=num_checks)


# --------------------------------------------------------------------------
# Ray BFS (ref raytrace/breadth_first/breadth_first.jl)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("start_level", "narrow", "capacity"))
def bfs_rays_fixed(bvh: BVH, points, directions, start_level: int,
                   capacity: int, narrow=None):
    """Node-ray BVTT with <=2 sprouts per hit; points/directions are
    coordinate tuples of (K,) lane arrays."""
    tree = bvh.tree
    idt = bvh.skips.dtype
    levels = tree.levels
    nrays = points[0].shape[0]

    # initial cross product (node at start_level) x ray
    n_nodes = tree.level_nodes(start_level)
    first = 1 << (start_level - 1)
    k = jnp.arange(n_nodes * nrays, dtype=idt)
    inode = k // nrays + first
    iray = k % nrays  # 0-based lane into rays
    n = jnp.asarray(inode.shape[0], idt)
    num_checks = n
    overflow = jnp.asarray(inode.shape[0] > capacity)

    def pad(a):
        return jnp.concatenate(
            [a, jnp.zeros((max(capacity - a.shape[0], 0),), idt)])[:capacity]
    inode, iray = pad(inode), pad(iray)
    lane = jnp.arange(capacity, dtype=idt)

    def ray_of(ir):
        j = jnp.clip(ir, 0, nrays - 1)
        return (tuple(c[j] for c in points), tuple(c[j] for c in directions))

    for level in range(start_level, levels):
        mask = lane < n
        node = _gather_nodes(bvh, inode, level)
        p, d = ray_of(iray)
        hit = isintersection(node, p, d) & mask
        virt = _virt_child(tree, inode, level)
        slots = [(2 * inode, iray, hit),
                 (2 * inode + 1, iray, hit & ~virt)]
        inode, iray, n = _expand(slots, capacity, idt)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)

    mask = lane < n
    leaf = _gather_leaves(bvh, inode)
    p, d = ray_of(iray)
    hit = isintersection(leaf.volume, p, d) & mask
    if narrow is not None:
        hit = hit & narrow(leaf, p, d)
    o1, o2, total = _compact(hit, leaf.index, iray + 1, capacity, idt)
    overflow = overflow | (total > capacity)
    return total, jnp.stack([o1, o2], axis=-1), num_checks, overflow


def traverse_rays_bfs(bvh: BVH, points, directions, *, start_level: int,
                      narrow=None, options: BVHOptions = DEFAULT_OPTIONS):
    n_init = bvh.tree.level_nodes(start_level) * points[0].shape[0]
    cap0 = _bfs_capacity0(n_init, max(bvh.num_leaves, points[0].shape[0]),
                          options)
    total, out, num_checks = _run_with_growth(
        lambda c: bfs_rays_fixed(bvh, points, directions, start_level, c,
                                 narrow), cap0, options)
    return BVHTraversal(num_contacts=total, cache1=out,
                        cache2=jnp.zeros((0,), bvh.skips.dtype),
                        start_level1=start_level, num_checks=num_checks)
