"""Implicit binary tree index algebra.

Counterpart of the reference's ``ImplicitTree``
(/root/reference/src/implicit_tree.jl:52-199).

Key design departure from the reference: because array shapes are jit-static
in XLA, the *entire* tree shape (levels, virtual node counts, per-level memory
offsets, skips) is computed in pure Python and constant-folded into compiled
programs.  Only per-lane queries with *traced* node indices (``memory_index``
on a traced implicit index inside a traversal kernel) touch device code, and
those read the static ``skips`` table.

Terminology (identical to the reference):

- Nodes are labelled 1-based in BFS order over a *perfect* binary tree; node
  ``i`` has children ``2i`` and ``2i+1``.
- Level 1 is the root; level ``levels`` is the leaf level.
- Leaves beyond ``real_leaves`` are *virtual*: never stored, never visited.
- Real nodes are stored contiguously per level, skipping virtual slots; the
  per-level ``skips`` table gives the number of virtual nodes before a level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from .utils import ilog2_static, floor_ilog2


def _popcount(x: int) -> int:
    return bin(x).count("1")


@dataclasses.dataclass(frozen=True)
class ImplicitTree:
    """Static shape of an implicit BVH tree over ``real_leaves`` elements.

    Mirrors ref /root/reference/src/implicit_tree.jl:77-90; all fields are
    Python ints so the tree can be a jit-static argument.
    """

    levels: int
    real_leaves: int
    real_nodes: int
    virtual_leaves: int
    virtual_nodes: int

    @classmethod
    def from_num_leaves(cls, num_leaves: int) -> "ImplicitTree":
        if num_leaves < 1:
            raise ValueError("must have at least one geometry!")
        lr = int(num_leaves)
        levels = ilog2_static(lr, round_up=True) + 1
        lv = (1 << (levels - 1)) - lr
        nv = 2 * lv - _popcount(lv)
        nr = 2 * lr - 1 + _popcount(lv)
        return cls(levels=levels, real_leaves=lr, real_nodes=nr,
                   virtual_leaves=lv, virtual_nodes=nv)

    # -- static queries ----------------------------------------------------

    def virtual_nodes_before_level(self, level: int) -> int:
        """Number of virtual nodes on levels strictly above ``level``.

        Ref skips table semantics (src/implicit_tree.jl:100-113): a node at
        implicit index ``i`` on ``level`` lives at memory slot
        ``i - virtual_nodes_before_level(level)`` (1-based).
        """
        vnl = self.virtual_leaves >> (self.levels - (level - 1))
        return 2 * vnl - _popcount(vnl)

    def memory_index(self, implicit_index: int) -> int:
        """Memory index (1-based) of a real node at ``implicit_index``.

        Ref: src/implicit_tree.jl:128-148.
        """
        if not (1 <= implicit_index <= (1 << self.levels) - 1):
            raise IndexError(implicit_index)
        level = ilog2_static(implicit_index) + 1
        return implicit_index - self.virtual_nodes_before_level(level)

    def level_nodes(self, level: int) -> int:
        """Number of real nodes at ``level``."""
        return (1 << (level - 1)) - (self.virtual_leaves >> (self.levels - level))

    def level_indices(self, level: int):
        """(start, stop) 1-based inclusive memory-index range of ``level``.

        Ref: src/implicit_tree.jl:156-171.
        """
        if not (1 <= level <= self.levels):
            raise IndexError(level)
        start = self.memory_index(1 << (level - 1))
        return start, start + self.level_nodes(level) - 1

    def isvirtual(self, implicit_index: int) -> bool:
        """Ref: src/implicit_tree.jl:179-199."""
        if not (1 <= implicit_index <= (1 << self.levels) - 1):
            raise IndexError(implicit_index)
        level = ilog2_static(implicit_index) + 1
        level_first = 1 << (level - 1)
        return implicit_index - level_first + 1 > self.level_nodes(level)

    # -- device-side tables ------------------------------------------------

    def skips_np(self, dtype=np.int32) -> np.ndarray:
        """Per-level virtual-node skip counts as a host array.

        ``skips[l - 1]`` (0-based python indexing for 1-based level ``l``)
        equals ``virtual_nodes_before_level(l)``.  Embedded as a compile-time
        constant in traversal kernels; ref computes this with a device kernel
        (src/implicit_tree.jl:100-120) but it is O(levels) host math here.
        """
        return np.array(
            [self.virtual_nodes_before_level(l) for l in range(1, self.levels + 1)],
            dtype=dtype,
        )

    @property
    def num_nodes(self) -> int:
        """Number of stored (non-leaf) real nodes."""
        return self.real_nodes - self.real_leaves


# --------------------------------------------------------------------------
# Traced per-lane queries (used inside traversal kernels)
# --------------------------------------------------------------------------

def isvirtual_traced(tree: ImplicitTree, implicit_index):
    """Vectorized isvirtual for traced implicit-index arrays."""
    level = floor_ilog2(implicit_index) + 1
    level_first = jnp.left_shift(jnp.ones_like(implicit_index), level - 1)
    nreal = level_first - jnp.right_shift(
        jnp.asarray(tree.virtual_leaves, implicit_index.dtype), tree.levels - level
    )
    return implicit_index - level_first + 1 > nreal


def memory_index_traced(tree: ImplicitTree, implicit_index, skips=None):
    """Vectorized memory index (1-based) for traced implicit indices.

    ``skips`` may be passed as a device array to avoid re-materialisation.
    """
    level = floor_ilog2(implicit_index) + 1
    if skips is None:
        skips = jnp.asarray(tree.skips_np())
    return implicit_index - skips[level - 1].astype(implicit_index.dtype)


def compute_skips(tree: ImplicitTree, dtype=jnp.int32):
    """Device array of per-level skips (API parity with ref compute_skips)."""
    return jnp.asarray(tree.skips_np(), dtype=dtype)
