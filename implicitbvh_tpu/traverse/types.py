"""Traversal result and algorithm types.

Counterpart of /root/reference/src/traverse/traverse.jl:1-107.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


class TraversalAlgorithm:
    """Base marker (ref traverse.jl:36)."""


@dataclasses.dataclass(frozen=True)
class BFSTraversal(TraversalAlgorithm):
    """Simultaneous breadth-first (level-synchronous BVTT) traversal.

    Theoretical-minimum contact checks, higher peak memory (ref
    traverse.jl:19-24).  Here: static-capacity frontier buffers with
    deterministic cumsum/scatter stream compaction per level.
    """


@dataclasses.dataclass(frozen=True)
class LVTTraversal(TraversalAlgorithm):
    """Leaf-vs-tree traversal — the default (ref traverse.jl:26-34).

    Here: a manually-vectorized *stackless* walk (trailing-ones climb
    instead of the reference's 32-deep per-thread stack) over all leaves in
    lockstep, with the two-pass count -> scan -> write output scheme.
    """


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVHTraversal:
    """Traversal result (ref BVHTraversal, traverse.jl:54-107).

    ``cache1`` holds the contact pairs as an (capacity, 2) index array;
    ``contacts`` views the first ``num_contacts`` rows.  ``num_contacts`` may
    be a device scalar (when produced inside jit by the fixed-capacity path)
    or a Python int.  ``cache2`` is the per-lane count/offset buffer, exposed
    for parity with the reference's reusable second cache.
    """

    num_contacts: jnp.ndarray
    cache1: jnp.ndarray
    cache2: jnp.ndarray
    start_level1: int = dataclasses.field(metadata=dict(static=True), default=1)
    start_level2: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_checks: int = dataclasses.field(metadata=dict(static=True), default=0)
    # capacity of the intermediate tile-pair list and the effective (possibly
    # growth-enlarged) tile algorithm (tile traversal only); carried so
    # ``traverse(..., cache=prev)`` re-uses compiled capacities (the XLA
    # analogue of the reference's resize!-based buffer reuse,
    # ref src/traverse/traverse.jl:120-145)
    pair_capacity: int = dataclasses.field(metadata=dict(static=True),
                                           default=0)
    tile_alg: object = dataclasses.field(metadata=dict(static=True),
                                         default=None)

    @property
    def start_level(self) -> int:
        return self.start_level1

    @property
    def contacts(self):
        n = int(self.num_contacts)
        return self.cache1[:n]

    def contacts_list(self):
        """Contacts as a list of Python int tuples (test/debug helper)."""
        import numpy as np
        return [tuple(int(v) for v in row) for row in np.asarray(self.contacts)]

    def __repr__(self):
        try:
            n = int(self.num_contacts)
        except Exception:  # traced
            n = self.num_contacts
        return (f"BVHTraversal\n  start_level1: {self.start_level1}\n"
                f"  start_level2: {self.start_level2}\n"
                f"  num_checks:   {self.num_checks}\n"
                f"  num_contacts: {n}\n"
                f"  cache1:       {self.cache1.shape}\n"
                f"  cache2:       {self.cache2.shape}")
