"""Public traversal API: ``traverse`` with algorithm dispatch and the
capacity-managing host wrapper.

Mirrors /root/reference/src/traverse/traverse.jl:110-256.  The host wrapper
performs exactly one device->host sync per traversal (the contact total —
the reference's LVT does the same, traverse_single.jl:60) and manages the
static output capacity with a growth policy, the XLA analogue of the
reference's ``resize!``-based cache reuse.  For sync-free pipelines use the
``*_fixed`` functions, which stay fully on device.
"""

from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp

from ..build import BVH
from ..options import DEFAULT_OPTIONS, BVHOptions
from .types import BFSTraversal, BVHTraversal, LVTTraversal, TraversalAlgorithm
from . import lvt as _lvt


def default_start_level(bvh: BVH, alg: TraversalAlgorithm = LVTTraversal()) -> int:
    """Ref: breadth_first.jl:4-6 and leaf_vs_tree.jl:4-6.

    DFS also takes the deep BFS-style default: its lane count equals the
    initial BVTT width, so starting at level 1 would serialize the whole
    pair tree onto a single lane's stack walk.
    """
    from .dfs import DFSTraversal
    if isinstance(alg, (BFSTraversal, DFSTraversal)):
        return max(bvh.tree.levels // 2, bvh.built_level)
    return max(1, bvh.built_level)


def _round_capacity(total: int, options: BVHOptions,
                    cache: Optional[BVHTraversal] = None) -> int:
    """Round a required size up to the compile-friendly capacity grid.

    When a previous traversal's ``cache`` already has enough room, its
    capacity is re-used verbatim so the write pass hits the compiled
    program (reference cache-reuse contract, ref traverse_single.jl:76-89).
    """
    need = max(int(total), options.min_capacity)
    if cache is not None and cache.cache1.ndim == 2 \
            and cache.cache1.shape[0] >= need:
        return cache.cache1.shape[0]
    return 1 << math.ceil(math.log2(need))


# The engine each query kind gets on the GPU: the faster of the dense-tile
# engine and the LVT walk, timed on one H100 at the benchmark sizes
# (PERF.md, "Engine routing").  Other backends keep the LVT walk, the
# reference's own default.
GPU_ENGINES = {"self": "tiles", "pair": "tiles", "rays": "tiles"}


def default_algorithm(kind: str, *bvhs: BVH) -> TraversalAlgorithm:
    """Pick the default traversal algorithm for a query ``kind`` ("self",
    "pair" or "rays"), like the reference routes its default to the
    fastest implementation (LVT, ref traverse.jl:26-34).  The tile engine
    needs one leaf volume kind across both trees."""
    import jax

    from .tiles import TileTraversal
    if jax.default_backend() == "gpu" and GPU_ENGINES[kind] == "tiles" \
            and len({b.leaf_kind for b in bvhs}) == 1:
        return TileTraversal()
    return LVTTraversal()


def _finish(total, out, offsets, start_level1, start_level2=0, num_checks=0):
    return BVHTraversal(
        num_contacts=total, cache1=out, cache2=offsets,
        start_level1=start_level1, start_level2=start_level2,
        num_checks=num_checks)


def traverse(bvh: BVH,
             *args,
             start_level: Optional[int] = None,
             start_level1: Optional[int] = None,
             start_level2: Optional[int] = None,
             narrow=None,
             cache: Optional[BVHTraversal] = None,
             options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """Contact detection: ``traverse(bvh)`` for self-contact or
    ``traverse(bvh1, bvh2)`` for two-tree contact, with an optional
    algorithm argument (``LVTTraversal()`` default, or ``BFSTraversal()``).

    Ref: src/traverse/traverse.jl:121-230.  Returns a :class:`BVHTraversal`
    whose ``contacts`` are (i, j) user-index pairs — sorted (min, max) for
    self-contact, tree-order (i1, i2) for pair contact.

    With no explicit algorithm the engine is :func:`default_algorithm`'s
    choice for the backend.  ``start_level`` tunes where the
    *tree-walking* algorithms (LVT, BFS, DFS) seed their frontier.  The
    dense-tile engine does not walk the tree at all (it re-derives coarse bounds from leaf
    tiles), so an explicit ``start_level`` emits a ``UserWarning`` there
    rather than being silently dead; pass ``LVTTraversal()``/
    ``BFSTraversal()`` if start-level control matters.
    """
    bvh2: Optional[BVH] = None
    alg: Optional[TraversalAlgorithm] = None
    for a in args:
        if isinstance(a, BVH):
            bvh2 = a
        elif isinstance(a, TraversalAlgorithm):
            alg = a
        else:
            raise TypeError(f"unexpected positional argument {a!r}")
    if alg is None:
        alg = (default_algorithm("self", bvh) if bvh2 is None
               else default_algorithm("pair", bvh, bvh2))

    if bvh2 is not None:
        return _traverse_pair(bvh, bvh2, alg,
                              start_level1=start_level1,
                              start_level2=start_level2,
                              narrow=narrow, cache=cache, options=options)

    explicit_start = start_level is not None
    if start_level is None:
        start_level = default_start_level(bvh, alg)
    if not (bvh.built_level <= start_level <= bvh.tree.levels):
        raise ValueError(
            f"need built_level <= start_level <= levels, got {start_level}")

    if bvh.tree.real_nodes <= 1:
        return _lvt._empty_traversal(bvh, start_level)

    if isinstance(alg, BFSTraversal):
        from . import bfs as _bfs
        return _bfs.traverse_bfs_single(bvh, start_level=start_level,
                                        narrow=narrow, cache=cache,
                                        options=options)

    from .dfs import DFSTraversal, traverse_dfs_single
    if isinstance(alg, DFSTraversal):
        return traverse_dfs_single(bvh, start_level=start_level,
                                   narrow=narrow, cache=cache,
                                   options=options)

    from .tiles import TileTraversal, traverse_tiles
    if isinstance(alg, TileTraversal):
        if explicit_start:
            import warnings
            warnings.warn(
                "start_level has no effect on the dense-tile engine (it "
                "does not walk the tree); use LVTTraversal()/BFSTraversal()"
                " for start-level control", UserWarning, stacklevel=2)
        return traverse_tiles(bvh, alg=alg, narrow=narrow, cache=cache,
                              options=options)

    counts = _lvt.lvt_count_single(bvh, start_level, narrow)
    offsets = jnp.cumsum(counts) - counts
    total = int(counts.sum())           # the single host sync
    capacity = _round_capacity(total, options, cache)
    out = _lvt.lvt_write_single(bvh, offsets, start_level, capacity, narrow)
    return _finish(total, out, offsets, start_level)


def _traverse_pair(bvh1: BVH, bvh2: BVH, alg: TraversalAlgorithm, *,
                   start_level1, start_level2, narrow, cache, options):
    explicit_start = start_level1 is not None or start_level2 is not None
    if start_level1 is None:
        start_level1 = default_start_level(bvh1, alg)
    if start_level2 is None:
        start_level2 = default_start_level(bvh2, alg)
    for b, sl in ((bvh1, start_level1), (bvh2, start_level2)):
        if not (b.built_level <= sl <= b.tree.levels):
            raise ValueError(f"invalid start level {sl}")

    from .tiles import TileTraversal, traverse_tiles_pair
    if isinstance(alg, TileTraversal):
        if explicit_start:
            import warnings
            warnings.warn(
                "start_level1/start_level2 have no effect on the dense-tile"
                " engine (it does not walk the trees); use LVTTraversal()/"
                "BFSTraversal() for start-level control",
                UserWarning, stacklevel=3)
        return traverse_tiles_pair(bvh1, bvh2, alg=alg, narrow=narrow,
                                   cache=cache, options=options)

    if isinstance(alg, BFSTraversal):
        from . import bfs as _bfs
        return _bfs.traverse_bfs_pair(bvh1, bvh2,
                                      start_level1=start_level1,
                                      start_level2=start_level2,
                                      narrow=narrow, cache=cache,
                                      options=options)

    if bvh1.num_leaves >= bvh2.num_leaves:
        lanes, target, sl, flip = bvh1.leaves, bvh2, start_level2, False
    else:
        lanes, target, sl, flip = bvh2.leaves, bvh1, start_level1, True
    counts = _lvt.lvt_count_pair(lanes, target, sl, narrow, flip)
    offsets = jnp.cumsum(counts) - counts
    total = int(counts.sum())
    capacity = _round_capacity(total, options, cache)
    out = _lvt.lvt_write_pair(lanes, target, offsets, sl, capacity,
                              narrow, flip)
    return _finish(total, out, offsets, start_level1, start_level2)
