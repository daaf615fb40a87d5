"""BVH construction: wrap -> Morton encode -> sort -> bottom-up aggregate.

Counterpart of /root/reference/src/build.jl.  The whole build is
one fused XLA program with **zero host synchronisation**:

- wrapping is an ``arange`` (ref wrap_bounding_volumes, build.jl:328-352);
- Morton encoding is two reductions + one elementwise pass (see morton.py);
- the Morton sort uses ``jax.lax.sort`` (key-value, stable), replacing
  ``AK.sort!`` (ref build.jl:248-253 — the build bottleneck);
- bottom-up aggregation (ref aggregate_oibvh!, build.jl:366-523) exploits the
  contiguous per-level node layout: the children of level ``l`` occupy one
  contiguous slice, so each level's merge is a strided slice + vectorized
  merge — *no gathers, no per-level kernel launches*, and the virtual-right
  special case is a statically-known single element (only the last parent of
  a level can have a virtual right child).

Tree shape, per-level offsets and the skips table are all jit-static
(see tree.py), so the unrolled level loop compiles to a flat fused program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from .morton import (DefaultMortonAlgorithm, ExtendedMortonAlgorithm,
                     morton_encode, morton_encode_extended)
from .options import DEFAULT_OPTIONS, BVHOptions
from .tree import ImplicitTree, compute_skips
from .volumes import (BBox, BSphere, Volume, center_coords, convert_volume,
                      merge, merge_into)


class Leaves(NamedTuple):
    """Batched counterpart of the reference's ``BoundingVolume{V, I, M}``
    wrapper (ref src/bounding_volumes/bounding_volumes.jl:55-70): the leaf
    volumes plus user indices (reported in contacts) and Morton code slots.

    ``morton`` is an (N,) unsigned array, or a ``(hi, lo)`` pair of uint32
    arrays for 64-bit codes without x64 (no uint64).
    """

    volume: Volume
    index: jnp.ndarray
    morton: Union[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]


# API-parity alias: reference calls the element type BoundingVolume.
BoundingVolume = Leaves


def wrap_bounding_volumes(volumes: Volume, options: BVHOptions = DEFAULT_OPTIONS,
                          indices: Optional[jnp.ndarray] = None) -> Leaves:
    """Attach user indices and (dummy) Morton codes to a batch of volumes.

    Default indices are 1-based — matching the reference's contact reporting
    (ref build.jl:328-352), e.g. the README demo contacts (1,2),(2,3),(4,5).
    """
    n = volumes.batch_shape[0]
    idt = options.index_dtype
    if indices is None:
        indices = jnp.arange(1, n + 1, dtype=idt)
    else:
        indices = jnp.asarray(indices, dtype=idt)
    alg = options.morton
    if alg.bits == 64 and not jax.config.jax_enable_x64:
        morton = (jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32))
    else:
        mdt = {16: jnp.uint16, 32: jnp.uint32, 64: jnp.uint64}[alg.bits]
        morton = jnp.zeros(n, mdt)
    return Leaves(volume=volumes, index=indices, morton=morton)


def _sort_by_morton(leaves: Leaves) -> Leaves:
    """Sort leaves along the Z-curve (ref build.jl:248-253).

    Uses a single *variadic* ``lax.sort`` carrying every leaf field through
    the sort instead of sorting (key, iota) and gathering each field.
    """
    vol = leaves.volume
    if isinstance(vol, BSphere):
        data = [*vol.xs, vol.r]
    else:
        data = [*vol.los, *vol.ups]
    if isinstance(leaves.morton, tuple):
        keys = list(leaves.morton)
    else:
        keys = [leaves.morton]
    ops = jax.lax.sort((*keys, *data, leaves.index), num_keys=len(keys),
                       is_stable=True)
    keys_s = ops[:len(keys)]
    data_s = ops[len(keys):-1]
    index_s = ops[-1]
    if isinstance(vol, BSphere):
        vol_s = BSphere(tuple(data_s[:3]), data_s[3])
    else:
        vol_s = BBox(tuple(data_s[:3]), tuple(data_s[3:6]))
    morton_s = tuple(keys_s) if len(keys_s) == 2 else keys_s[0]
    return Leaves(volume=vol_s, index=index_s, morton=morton_s)


def _node_kind_of(volume: Volume):
    return BSphere if isinstance(volume, BSphere) else BBox


def _aggregate_bbox_fast(leaves_vol: Volume, tree: ImplicitTree,
                         built_level: int) -> BBox:
    """Fast path for BBox nodes: since box merges are pure min/max (and the
    reference's enclosure-aware sphere->box pair constructor provably equals
    the plain union of the two spheres' boxes), every level is an
    associative reduction.

    The six box coordinates are stacked — ``up`` negated so all six reduce
    with ``min`` — into one (6, N) array, the leaf level is padded to the
    perfect-tree width with +inf (min-neutral, which also reproduces the
    reference's virtual-right-child copy semantics), and each level is one
    ``reshape(6, -1, 2).min(-1)`` halving of the one below.
    """
    from .volumes import bbox_of_bsphere
    levels = tree.levels
    dtype = leaves_vol.dtype
    num_nodes = tree.num_nodes

    if levels < 2 or tree.real_nodes < 2:
        z = jnp.zeros((3, max(num_nodes, 0)), dtype)
        return BBox((z[0], z[1], z[2]), (z[0], z[1], z[2]))

    box = leaves_vol if isinstance(leaves_vol, BBox) \
        else bbox_of_bsphere(leaves_vol)
    stacked = jnp.stack([*box.los, -box.ups[0], -box.ups[1], -box.ups[2]])
    full = 1 << (levels - 1)
    n = tree.real_leaves
    if full > n:
        pad = jnp.full((6, full - n), jnp.inf, dtype)
        stacked = jnp.concatenate([stacked, pad], axis=1)

    per_level = {}
    c = stacked
    stop = max(built_level, 1)
    for lvl in range(levels - 1, stop - 1, -1):
        c = c.reshape(6, -1, 2).min(-1)
        per_level[lvl] = c[:, :tree.level_nodes(lvl)]

    chunks = []
    for lvl in range(1, levels):
        if lvl in per_level:
            chunks.append(per_level[lvl])
        else:
            chunks.append(jnp.zeros((6, tree.level_nodes(lvl)), dtype))
    flat = jnp.concatenate(chunks, axis=1)
    return BBox((flat[0], flat[1], flat[2]), (-flat[3], -flat[4], -flat[5]))


def _aggregate(leaves_vol: Volume, tree: ImplicitTree, built_level: int,
               node_kind) -> Volume:
    """Bottom-up level-synchronous merge (ref aggregate_oibvh!, build.jl:366-523).

    Returns the flat node array in memory-index layout (level 1 first).
    Levels above ``built_level`` that are not built are zero-filled.
    BBox nodes take the stacked min-reduction fast path; BSphere nodes use
    the generic pairwise merge (the enclosure-aware sphere merge is not
    associative, so it must stay tree-structured).
    """
    if node_kind is BBox:
        return _aggregate_bbox_fast(leaves_vol, tree, built_level)
    levels = tree.levels
    dtype = leaves_vol.dtype

    def zeros_like_level(m):
        z3 = tuple(jnp.zeros((m,), dtype) for _ in range(3))
        if node_kind is BSphere:
            return BSphere(z3, jnp.zeros((m,), dtype))
        return BBox(z3, tuple(jnp.zeros((m,), dtype) for _ in range(3)))

    if levels < 2 or tree.real_nodes < 2:
        return zeros_like_level(tree.num_nodes)

    per_level: dict = {}

    # --- level above the leaves: leaf->node type conversion + pair merge
    # (ref aggregate_last_level!, build.jl:381-457)
    lvl = levels - 1
    m = tree.level_nodes(lvl)
    n_child = tree.real_leaves
    if n_child == 2 * m:
        merged = merge_into(node_kind, leaves_vol[0::2], leaves_vol[1::2])
    else:
        # Last parent has a virtual right child: copy/convert the left child.
        merged = merge_into(node_kind, leaves_vol[0:n_child - 1:2],
                            leaves_vol[1:n_child:2])
        last = convert_volume(node_kind, leaves_vol[n_child - 1:n_child])
        merged = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=0), merged, last)
    per_level[lvl] = merged

    # --- upper levels (ref aggregate_level!, build.jl:460-523)
    for lvl in range(levels - 2, max(built_level, 1) - 1, -1):
        child = per_level[lvl + 1]
        m = tree.level_nodes(lvl)
        n_child = tree.level_nodes(lvl + 1)
        if n_child == 2 * m:
            merged = merge(child[0::2], child[1::2])
        else:
            merged = merge(child[0:n_child - 1:2], child[1:n_child:2])
            last = child[n_child - 1:n_child]
            merged = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=0), merged, last)
        per_level[lvl] = merged

    # --- concatenate in memory-index order (level 1 ... levels-1)
    chunks = []
    for lvl in range(1, levels):
        if lvl in per_level:
            chunks.append(per_level[lvl])
        else:
            chunks.append(zeros_like_level(tree.level_nodes(lvl)))
    return jax.tree_util.tree_map(
        lambda *a: jnp.concatenate(a, axis=0), *chunks)


def compute_build_level(tree: ImplicitTree, built_level) -> int:
    """Integer or fractional (0..1) built level (ref build.jl:309-325)."""
    if isinstance(built_level, int):
        if not 1 <= built_level <= tree.levels:
            raise ValueError(f"built_level {built_level} out of [1, {tree.levels}]")
        return built_level
    if isinstance(built_level, float):
        if not 0.0 <= built_level <= 1.0:
            raise ValueError("fractional built_level must be in [0, 1]")
        # round-half-even like Julia's round, matching the reference
        import builtins
        return int(builtins.round(tree.levels + (1 - tree.levels) * built_level))
    raise TypeError(f"built_level must be int or float, got {type(built_level)}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVH:
    """Implicit bounding volume hierarchy (ref src/build.jl:155-166).

    Construct with :func:`build`; fields:

    - ``built_level``: level up to which the tree has been aggregated (static)
    - ``tree``: the static :class:`ImplicitTree` shape
    - ``skips``: per-level virtual-node skip table (device array)
    - ``nodes``: SoA node volumes in memory-index layout
    - ``leaves``: Morton-sorted :class:`Leaves`
    """

    skips: jnp.ndarray
    nodes: Volume
    leaves: Leaves
    built_level: int = dataclasses.field(metadata=dict(static=True))
    tree: ImplicitTree = dataclasses.field(metadata=dict(static=True))

    @property
    def num_leaves(self) -> int:
        return self.tree.real_leaves

    @property
    def node_kind(self):
        return _node_kind_of(self.nodes)

    @property
    def leaf_kind(self):
        return _node_kind_of(self.leaves.volume)

    def __repr__(self):  # pretty printer, ref build.jl:182-194
        return (f"BVH\n  built_level: {self.built_level}\n"
                f"  tree:        ImplicitTree(levels={self.tree.levels}, "
                f"real_leaves={self.tree.real_leaves})\n"
                f"  nodes:       {type(self.nodes).__name__}"
                f"[{self.tree.num_nodes}]\n"
                f"  leaves:      {type(self.leaves.volume).__name__}"
                f"[{self.tree.real_leaves}]")


def build(bounding_volumes: Union[Volume, Leaves],
          node_kind=BBox,
          *,
          built_level: Union[int, float] = 1,
          cache: Optional[BVH] = None,
          options: BVHOptions = DEFAULT_OPTIONS,
          indices: Optional[jnp.ndarray] = None) -> BVH:
    """Build a BVH (ref BVH constructor, src/build.jl:198-271).

    ``bounding_volumes`` is a batched :class:`BSphere`/:class:`BBox` (or
    pre-wrapped :class:`Leaves` carrying custom user indices).  ``node_kind``
    selects the node volume type (leaves may differ, e.g. BSphere leaves
    merged into BBox nodes).

    ``cache`` is accepted for API parity with the reference's
    allocation-reusing rebuilds; in XLA, buffer reuse happens through jit
    donation instead, so it is semantically a no-op here.  Fully traceable:
    call inside ``jax.jit`` for fused, sync-free rebuilds.
    """
    del cache  # buffer reuse is handled by XLA donation under jit

    with jax.named_scope("build"):
        if options.index_bits == 64 and not jax.config.jax_enable_x64:
            # without x64, jnp silently narrows int64 -> int32: a user asking
            # for 64-bit indices on a > 2^31-pair workload would get silent
            # wraparound rather than a loud failure
            raise ValueError(
                "BVHOptions(index_bits=64) requires jax_enable_x64 "
                "(jax.config.update('jax_enable_x64', True)); prefer "
                "32-bit indices on-device")

        if isinstance(bounding_volumes, Leaves):
            leaves = bounding_volumes
            leaves = Leaves(leaves.volume,
                            jnp.asarray(leaves.index, options.index_dtype),
                            leaves.morton)
        else:
            leaves = wrap_bounding_volumes(bounding_volumes, options, indices)

        n = leaves.index.shape[0]
        tree = ImplicitTree.from_num_leaves(n)
        built_ilevel = compute_build_level(tree, built_level)

        alg = options.morton
        if isinstance(alg, ExtendedMortonAlgorithm):
            morton = morton_encode_extended(leaves.volume, alg)
        elif isinstance(alg, DefaultMortonAlgorithm):
            morton = morton_encode(center_coords(leaves.volume), alg)
        else:
            raise TypeError(f"unsupported morton algorithm {alg}")
        leaves = Leaves(leaves.volume, leaves.index, morton)
        leaves = _sort_by_morton(leaves)

        nodes = _aggregate(leaves.volume, tree, built_ilevel, node_kind)
        skips = compute_skips(tree, options.index_dtype)

        return BVH(skips=skips, nodes=nodes, leaves=leaves,
                   built_level=built_ilevel, tree=tree)
